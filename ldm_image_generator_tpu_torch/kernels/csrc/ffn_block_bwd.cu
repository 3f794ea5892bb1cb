// Backward of the SwinBlock FFN towers, the Hopper counterpart of
// ffn_block_bwd_pallas (ldm_image_generator_tpu/kernels/ffn_block.py).
// From the saved h [N, C] and the out-cotangent g [N, C], for the general
// ReGLU and the two routed experts r:
//
//   a_r = h @ wa_r + ba_r,  b_r = h @ wb_r + bb_r      (fp32, recomputed)
//   dg_r = g @ wc_r^T                                   (fp32)
//   da_r = T(dg_r * relu(b_r)),  db_r = T(dg_r * a_r * [b_r > 0])
//   gate_r = T(a_r * relu(b_r))
//   dwa_r = h^T da_r, dba_r = sum_rows da_r, dwb_r = h^T db_r,
//   dbb_r = sum_rows db_r, dwc_r = gate_r^T g           (fp32)
//   dh = T(sum_r da_r @ wa_r^T + db_r @ wb_r^T)          (fp32 sum, one rounding)
//
// The TPU kernel carried the weight gradients in VMEM across a sequential
// grid; here blocks run in parallel and nothing carries between them.
// dtype: 0 = float32, 1 = bfloat16.
//
// bfloat16 at the widths ffn_tc.cuh takes (every UNet shape) runs on the
// tensor cores in two launches (namespace ftc). What bounds a call on the H100: the 48 N C
// M FLOP (6.4 GFLOP per call at every B=8 train shape), against 24-40 MB
// of operands and fp32 gradients, so operations below C = 1024; the
// design keeps every product on mma.sync and every block busy:
//   1. gate_grad_kernel: one block per (64-row tile, 64 hidden columns,
//      tower) runs h @ [wa | wb] (the h tile read once for both) and then
//      g @ wc^T (wc read transposed in place, ldmatrix) on the same ring,
//      and writes da, db and the gate;
//   2. tail_kernel, a programmatic dependent launch (it streams h, g and
//      the weights while 1 drains): the nine weight gradients A^T B over
//      the N rows (A through ldmatrix.trans), rows split over blocks where
//      there are fewer tiles than two per SM, with the bias gradients as
//      column sums of the landed da/db tiles carried through split_fixup;
//      and dh as one product over the six segments da_r wa_r^T, db_r
//      wb_r^T (weights read transposed), k split likewise. The kind whose
//      blocks run more k-tiles is scheduled first.
// Splits meet in split_fixup in a fixed order: reruns are bitwise equal.
//
// float32 at the same widths runs the same two launches with every
// product as three TF32 passes on the tensor cores (ffn_tf32_bwd.cuh),
// fp32 accurate. Both types at other widths keep the CUDA-core FMA
// chain: gate_grad_kernel (the two
// recompute products and dg in one block, da/db/gate to scratch in T), the
// weight gradients as atb products over the N rows (split over blocks,
// partials added in a second pass; the bias gradients are the ones-row of
// h^T), and dh as one abt product over six segments.
#include "ffn_tc.cuh"
#include "grad_common.cuh"

namespace ldm {

struct FfnBwdArgs {
  const void *h, *g;
  const void *gwa, *gba, *gwb, *gbb, *gwc;
  const void *wa, *ba, *wb, *bb, *wc;
  int E;
  const int* ids;
  int N, C, M;
  void* dgate;  // T [3 (da, db, gate)][3 towers][N][M]
};

// Weights of ReGLU r (0 general, 1 and 2 the routed experts).
template <typename T>
struct Tower {
  const T *wa, *ba, *wb, *bb, *wc;
};

template <typename T>
__device__ __forceinline__ Tower<T> tower(const FfnBwdArgs& a, int r) {
  if (r == 0)
    return {(const T*)a.gwa, (const T*)a.gba, (const T*)a.gwb, (const T*)a.gbb, (const T*)a.gwc};
  const size_t cm = (size_t)a.C * a.M;
  return {expert_slice((const T*)a.wa, a.ids, r - 1, a.E, cm),
          expert_slice((const T*)a.ba, a.ids, r - 1, a.E, (size_t)a.M),
          expert_slice((const T*)a.wb, a.ids, r - 1, a.E, cm),
          expert_slice((const T*)a.bb, a.ids, r - 1, a.E, (size_t)a.M),
          expert_slice((const T*)a.wc, a.ids, r - 1, a.E, cm)};
}

// grid (ceil(M / BN), ceil(N / BM), 3 towers).
template <typename T, typename S>
__global__ void __launch_bounds__(S::THREADS) gate_grad_kernel(FfnBwdArgs a) {
  const int r = blockIdx.z;
  const Tower<T> w = tower<T>(a, r);
  __shared__ TileSmem<S, 2> sm_ab;
  __shared__ TileSmem<S, 1> sm_dg;
  float ab[2][S::TM][S::TN], dg[1][S::TM][S::TN];
  zero_acc<S, 2>(ab);
  zero_acc<S, 1>(dg);
  const int row0 = blockIdx.y * S::BM, col0 = blockIdx.x * S::BN;
  const T* Bab[2] = {w.wa, w.wb};
  tile_product<S, 2>((const T*)a.h, a.C, a.N, a.C, row0, Bab, a.M, a.M, col0, 0, a.C, sm_ab, ab);
  // dg = g @ wc^T: wc [M, C] read transposed
  const T* Bdg[1] = {w.wc};
  tile_product<S, 1, false, true>((const T*)a.g, a.C, a.N, a.C, row0, Bdg, a.C, a.M, col0, 0,
                                  a.C, sm_dg, dg);
  const size_t nm = (size_t)a.N * a.M;
  T* da = (T*)a.dgate + (size_t)r * nm;
  T* db = (T*)a.dgate + (size_t)(3 + r) * nm;
  T* gate = (T*)a.dgate + (size_t)(6 + r) * nm;
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = acc_row<S>(i);
    if (row >= a.N) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int col = acc_col<S>(j);
      if (col >= a.M) continue;
      const float av = ab[0][i][j] + to_f(w.ba[col]);
      const float bv = ab[1][i][j] + to_f(w.bb[col]);
      const float relu_b = fmaxf(bv, 0.f);
      const float d = dg[0][i][j];
      const size_t o = (size_t)row * a.M + col;
      da[o] = from_f<T>(d * relu_b);
      db[o] = from_f<T>(d * av * (bv > 0.f ? 1.f : 0.f));
      gate[o] = from_f<T>(av * relu_b);
    }
  }
}

// grads: per tower r, [dwa (C x M) | dba (M)] [dwb | dbb] [dwc (M x C)],
// fp32; towers at stride ffn_bwd_tower_floats.
__host__ __device__ inline size_t tower_floats(int C, int M) {
  return (size_t)2 * (C + 1) * M + (size_t)M * C;
}

inline size_t bwd_scratch_floats(int N, int C, int M) {
  const size_t w1 = atb_part_floats(6, C, M, N, 1);
  const size_t w2 = atb_part_floats(3, M, C, N, 0);
  const size_t d = abt_plan(6, N, M, C).floats;
  size_t f = w1 > w2 ? w1 : w2;
  return f > d ? f : d;
}

template <typename T>
int ffn_backward(const FfnBwdArgs& a, void* dh, float* grads, float* scratch, cudaStream_t st) {
  const int N = a.N, C = a.C, M = a.M;
  if (use_large_tile(N, M)) {
    dim3 grid((M + TileL::BN - 1) / TileL::BN, (N + TileL::BM - 1) / TileL::BM, 3);
    gate_grad_kernel<T, TileL><<<grid, TileL::THREADS, 0, st>>>(a);
  } else {
    dim3 grid((M + TileS::BN - 1) / TileS::BN, (N + TileS::BM - 1) / TileS::BM, 3);
    gate_grad_kernel<T, TileS><<<grid, TileS::THREADS, 0, st>>>(a);
  }
  const size_t nm = (size_t)N * M, tw = tower_floats(C, M);
  const T* dg = (const T*)a.dgate;
  // dwa_r | dba_r and dwb_r | dbb_r: h^T [da_r | db_r], ones-row = bias
  AtbArgs w1{};
  w1.nmat = 6;
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 2; ++q) {
      const int z = 2 * r + q;
      w1.A[z] = a.h;
      w1.lda[z] = C;
      w1.B[z] = dg + (size_t)(3 * q + r) * nm;
      w1.ldb[z] = M;
      w1.out[z] = grads + r * tw + (size_t)q * (C + 1) * M;
    }
  w1.K = N; w1.R = C; w1.ncol = M; w1.ones = 1; w1.part = scratch;
  atb<T>(w1, st);
  // dwc_r = gate_r^T g
  AtbArgs w2{};
  w2.nmat = 3;
  for (int r = 0; r < 3; ++r) {
    w2.A[r] = dg + (size_t)(6 + r) * nm;
    w2.lda[r] = M;
    w2.B[r] = a.g;
    w2.ldb[r] = C;
    w2.out[r] = grads + r * tw + (size_t)2 * (C + 1) * M;
  }
  w2.K = N; w2.R = M; w2.ncol = C; w2.ones = 0; w2.part = scratch;
  atb<T>(w2, st);
  // dh = T(sum_r da_r wa_r^T + db_r wb_r^T): weights [C, M] read transposed
  AbtArgs d{};
  d.nseg = 6;
  const size_t cm = (size_t)C * M;
  const void* wsel[2][2] = {{a.gwa, a.wa}, {a.gwb, a.wb}};
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 2; ++q) {
      const int z = 2 * r + q;
      d.A[z] = dg + (size_t)(3 * q + r) * nm;
      d.lda[z] = M;
      d.B[z] = r == 0 ? WeightRef{wsel[q][0], -1, 0} : WeightRef{wsel[q][1], r - 1, cm};
    }
  d.ldb = M; d.ids = a.ids; d.E = a.E; d.N = N; d.K = M; d.ncol = C; d.out = dh; d.part = scratch;
  abt<T>(d, st);
  return (int)cudaGetLastError();
}

namespace ftc {

struct TailPlan {
  int dw_tiles, splits, per, n_dw;           // weight gradients: tiles x splits of the rows
  int dh_tn, dh_tiles, dh_splits, dh_per, n_dh;  // dh: tiles x splits of k = 6M
  int dh_first;                              // the kind with more k-tiles a block first
  size_t dw_floats, floats;                  // split partials: dW's, then in all
  int dh_counter0, counters;                 // split counters: dW's, then dh's from dh_counter0
};

inline TailPlan tail_plan(int N, int C, int M) {
  TailPlan p;
  p.dw_tiles = 9 * (C / Tile::BM) * (M / Tile::BN);
  const Split w = split_k(p.dw_tiles, (N + BK - 1) / BK);
  p.splits = w.splits;
  p.per = w.per;
  p.n_dw = p.dw_tiles * p.splits;
  p.dh_tn = C / Tile::BN;
  p.dh_tiles = ((N + Tile::BM - 1) / Tile::BM) * p.dh_tn;
  const Split d = split_k(p.dh_tiles, 6 * M / BK);
  p.dh_splits = d.splits;
  p.dh_per = d.per;
  p.n_dh = p.dh_tiles * p.dh_splits;
  p.dh_first = p.dh_per > p.per;
  p.dw_floats = p.splits > 1 ? (size_t)p.dw_tiles * p.splits * (TILE_F + THREADS) : 0;
  p.floats = p.dw_floats + (p.dh_splits > 1 ? (size_t)p.dh_tiles * p.dh_splits * TILE_F : 0);
  p.dh_counter0 = p.splits > 1 ? p.dw_tiles : 0;
  p.counters = p.dh_counter0 + (p.dh_splits > 1 ? p.dh_tiles : 0);
  return p;
}

// T: dh's type (bf16 here, float on the fp32 route of ffn_tf32_bwd.cuh)
template <typename T>
struct BwdArgsT {
  FfnBwdArgs f;
  TailPlan p;
  T* dh;
  float* grads;
  float *part, *dh_part;
  int* counters;
};
using BwdArgs = BwdArgsT<bf16>;

// grid (M / 64, ceil(N / 64), 3 towers).
__global__ void __launch_bounds__(THREADS) gate_grad_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  tc::griddep_launch();  // the tail may start streaming h, g and the weights
  const FfnBwdArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int r = blockIdx.z, nbh = blockIdx.x * HN, mb = blockIdx.y * Tile::BM;
  const Tower<bf16> w = tower<bf16>(f, r);
  const bf16* g = (const bf16*)f.g;
  __shared__ float bias_s[2 * HN];
  TileBias bias{bias_s, to_f((threadIdx.x < HN ? w.ba : w.bb)[nbh + threadIdx.x % HN])};
  float ab[GateG::MI][GateG::NI][4];
  ab_tile<GateG>(ab, ring, (const bf16*)f.h, N, C, M, w.wa, w.wb, mb, nbh, 0, C / BK, [] {});
  // dg = g @ wc^T: B stored [n = hidden column][k = C], wc [M, C] in place
  float dg[Tile::MI][Tile::NI][4];
  tc::gemm_tile<Tile, false, true>(
      dg, ring, 0, C / BK,
      [&](int rr, int c, int k0) -> const bf16* {
        return mb + rr < N ? g + (size_t)(mb + rr) * C + k0 + c : nullptr;
      },
      [&](int rr, int c, int k0) -> const bf16* {
        return w.wc + (size_t)(nbh + rr) * C + k0 + c;
      },
      [](const bf16*, int) {}, [] {});
  bias.share();
  const size_t nm = (size_t)N * M;
  bf16* da = (bf16*)f.dgate + (size_t)r * nm;
  bf16* db = (bf16*)f.dgate + (size_t)(3 + r) * nm;
  bf16* gate = (bf16*)f.dgate + (size_t)(6 + r) * nm;
  for_gate_pairs(mb, nbh, [&](int i, int q, int h, int row, int col) {
    if (row >= N) return;
    float av[2], bv[2], d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      av[e] = ab[i][2 * q][2 * h + e] + bias.at(0, col - nbh + e);
      bv[e] = ab[i][2 * q + 1][2 * h + e] + bias.at(1, col - nbh + e);
      d[e] = dg[i][q][2 * h + e];
    }
    const size_t o = (size_t)row * M + col;
    tc::store2(da + o, tc::pack_bf16(d[0] * fmaxf(bv[0], 0.f), d[1] * fmaxf(bv[1], 0.f)));
    tc::store2(db + o, tc::pack_bf16(d[0] * av[0] * (bv[0] > 0.f ? 1.f : 0.f),
                                     d[1] * av[1] * (bv[1] > 0.f ? 1.f : 0.f)));
    tc::store2(gate + o, tc::pack_bf16(av[0] * fmaxf(bv[0], 0.f), av[1] * fmaxf(bv[1], 0.f)));
  });
}

// n_dw blocks: the weight gradients z = 3 r + q of tower r, q = 0 dwa =
// h^T da_r (+ dba), 1 dwb = h^T db_r (+ dbb), 2 dwc = gate_r^T g, in 64 x
// 64 tiles x `splits` shares of the rows. n_dh blocks: dh in 64 x 64
// tiles x dh_splits shares of k = 6M.
__global__ void __launch_bounds__(THREADS) tail_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const FfnBwdArgs& f = a.f;
  const TailPlan& p = a.p;
  const int N = f.N, C = f.C, M = f.M;
  const size_t nm = (size_t)N * M;
  const bf16* dgate = (const bf16*)f.dgate;
  float acc[Tile::MI][Tile::NI][4];
  const int id = blockIdx.x;
  if (p.dh_first ? id < p.n_dh : id >= p.n_dw) {
    const int b = p.dh_first ? id : id - p.n_dw;
    const int s = b % p.dh_splits, tile = b / p.dh_splits;
    const int mb = (tile / p.dh_tn) * Tile::BM, nb = (tile % p.dh_tn) * Tile::BN;
    const int kt = 6 * M / BK, kt0 = min(kt, s * p.dh_per), kt1 = min(kt, kt0 + p.dh_per);
    // segment z = 2 r + q of k: da_r (q = 0) against wa_r, db_r against wb_r
    const Tower<bf16> w0 = tower<bf16>(f, 0), w1 = tower<bf16>(f, 1), w2 = tower<bf16>(f, 2);
    auto wseg = [&](int z) {
      const bf16* wa = z < 2 ? w0.wa : z < 4 ? w1.wa : w2.wa;
      const bf16* wb = z < 2 ? w0.wb : z < 4 ? w1.wb : w2.wb;
      return (z & 1) ? wb : wa;
    };
    tc::gemm_tile<Tile, false, true>(
        acc, ring, kt0, kt1,
        [&](int rr, int c, int k0) -> const bf16* {
          const int z = k0 / M;
          return mb + rr < N ? dgate + (size_t)(3 * (z & 1) + (z >> 1)) * nm +
                                   (size_t)(mb + rr) * M + k0 - z * M + c
                             : nullptr;
        },
        [&](int rr, int c, int k0) -> const bf16* {
          const int z = k0 / M;
          return wseg(z) + (size_t)(nb + rr) * M + k0 - z * M + c;
        },
        [](const bf16*, int) {}, [] { tc::griddep_wait(); });
    float none[1];
    if (p.dh_splits > 1 &&
        !tc::split_fixup<THREADS, Tile::MI, Tile::NI, 0>(
            acc, none, a.dh_part + (size_t)tile * p.dh_splits * TILE_F, p.dh_splits, s,
            a.counters + p.dh_counter0 + tile))
      return;
    tc::for_pairs<Tile>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
      if (row < N) tc::store2(a.dh + (size_t)row * C + col, tc::pack_bf16(v0, v1));
    });
    return;
  }
  const int b = p.dh_first ? id - p.n_dh : id, s = b % p.splits, tile = b / p.splits;
  const int per_z = p.dw_tiles / 9, z = tile / per_z, r = z / 3, q = z % 3;
  const int ncol = q < 2 ? M : C, tn = ncol / Tile::BN;
  const int mb = ((tile % per_z) / tn) * Tile::BM, nb = (tile % tn) * Tile::BN;
  // A [rows, R] (stored [k][m], read through ldmatrix.trans), B [rows, ncol]
  const bf16* A = q < 2 ? (const bf16*)f.h : dgate + (size_t)(6 + r) * nm;
  const bf16* B = q < 2 ? dgate + (size_t)(3 * q + r) * nm : (const bf16*)f.g;
  const int lda = q < 2 ? C : M;
  const int kt = (N + BK - 1) / BK, kt0 = min(kt, s * p.per), kt1 = min(kt, kt0 + p.per);
  auto src_a = [&](int rr, int c, int k0) -> const bf16* {
    return k0 + rr < N ? A + (size_t)(k0 + rr) * lda + mb + c : nullptr;
  };
  auto src_b = [&](int rr, int c, int k0) -> const bf16* {
    return k0 + rr < N ? B + (size_t)(k0 + rr) * ncol + nb + c : nullptr;
  };
  // bias gradient (dba, dbb): the tiles of the first row block also sum
  // B's columns; thread t takes column t % 64 over half the k-tile's rows
  const bool bias = q < 2 && mb == 0;
  float cs[2] = {0.f, 0.f};
  auto col_sums = [&](const bf16* bs, int ld) {
    if (!bias) return;
    const int col = threadIdx.x % Tile::BN, r0 = (threadIdx.x / Tile::BN) * (BK / 2);
#pragma unroll 8
    for (int rr = 0; rr < BK / 2; ++rr) cs[0] += to_f(bs[(r0 + rr) * ld + col]);
  };
  auto wait = [] { tc::griddep_wait(); };
  // what the first kernel writes (da, db, the gate) streams after the
  // wait; h or g before it
  if (q < 2)
    tc::gemm_tile<Tile, true, false, true>(acc, ring, kt0, kt1, src_a, src_b, col_sums, wait);
  else
    tc::gemm_tile<Tile, true, false, false>(acc, ring, kt0, kt1, src_a, src_b, col_sums, wait);
  if (p.splits > 1 &&
      !tc::split_fixup<THREADS, Tile::MI, Tile::NI, 1>(
          acc, cs, a.part + (size_t)tile * p.splits * (TILE_F + THREADS), p.splits, s,
          a.counters + tile))
    return;
  float* out = a.grads + r * tower_floats(C, M) + (size_t)q * (C + 1) * M;
  tc::for_pairs<Tile>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(out + (size_t)row * ncol + col) = make_float2(v0, v1);
  });
  if (bias) {
    __shared__ float half[Tile::BN];
    if (threadIdx.x >= Tile::BN) half[threadIdx.x - Tile::BN] = cs[0];
    __syncthreads();
    if (threadIdx.x < Tile::BN) out[(size_t)C * M + nb + threadIdx.x] = cs[0] + half[threadIdx.x];
  }
}

inline int backward(const FfnBwdArgs& f, void* dh, float* grads, float* scratch, int* counters,
                    cudaStream_t st) {
  const TailPlan p = tail_plan(f.N, f.C, f.M);
  if (p.counters > kCounters) return (int)cudaErrorInvalidValue;
  const BwdArgs a{f, p, (bf16*)dh, grads, scratch, scratch + p.dw_floats, counters};
  cudaError_t e = tc::launch(gate_grad_kernel, dim3(f.M / HN, (f.N + Tile::BM - 1) / Tile::BM, 3),
                             GateG::smem<false, false>(), st, tc::after_previous(false), a);
  if (e != cudaSuccess) return (int)e;
  constexpr size_t sm = Tile::smem<true, false>() > Tile::smem<false, true>()
                            ? Tile::smem<true, false>() : Tile::smem<false, true>();
  e = tc::launch(tail_kernel, dim3(p.n_dw + p.n_dh), sm, st, tc::after_previous(), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace ftc
}  // namespace ldm

// the float32 route, after the definitions it shares with the bf16 one
#include "ffn_tf32_bwd.cuh"

// The route of a backward call: bfloat16 and float32 at the widths the
// tensor-core kernels take (every UNet shape) run on them, as bf16
// mma.sync and as three TF32 passes; other widths on the FMA chain. It
// depends on the dtype and the shape alone (ffn_block's forward has its
// own rule, ffn_tensor_cores).
extern "C" int ffn_bwd_tensor_cores(int dtype, int N, int C, int M) {
  return (dtype == 0 || dtype == 1) && ldm::ftc::takes(N, C, M);
}

extern "C" int ffn_block_backward(int dtype, const void* h, const void* g, const void* gwa,
                                  const void* gba, const void* gwb, const void* gbb,
                                  const void* gwc, const void* wa, const void* ba,
                                  const void* wb, const void* bb, const void* wc, int E,
                                  const void* ids, int N, int C, int M, void* dh, void* dgate,
                                  void* grads, void* scratch, void* counters, void* stream) {
  const ldm::FfnBwdArgs a{h,  g,  gwa, gba, gwb, gbb, gwc, wa, ba, wb,
                          bb, wc, E,   (const int*)ids,     N,   C,  M,  dgate};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ffn_bwd_tensor_cores(dtype, N, C, M))
    return dtype == 0
               ? ldm::ftc::backward_f32(a, dh, (float*)grads, (float*)scratch, (int*)counters, st)
               : ldm::ftc::backward(a, dh, (float*)grads, (float*)scratch, (int*)counters, st);
  if (dtype == 0) return ldm::ffn_backward<float>(a, dh, (float*)grads, (float*)scratch, st);
  if (dtype == 1)
    return ldm::ffn_backward<__nv_bfloat16>(a, dh, (float*)grads, (float*)scratch, st);
  return (int)cudaErrorInvalidValue;
}

// fp32 floats of the gradient buffer (3 towers) and of the scratch.
extern "C" long long ffn_bwd_grad_floats(int C, int M) {
  return (long long)(3 * ldm::tower_floats(C, M));
}

extern "C" long long ffn_bwd_scratch_floats(int dtype, int N, int C, int M) {
  if (ffn_bwd_tensor_cores(dtype, N, C, M))
    return (long long)(dtype == 0 ? ldm::ftc::bwd_scratch_floats_f32(N, C, M)
                                  : ldm::ftc::tail_plan(N, C, M).floats);
  return (long long)ldm::bwd_scratch_floats(N, C, M);
}
