// ffn_block's float32 backward on the tensor cores (three TF32 passes,
// tf32_common.cuh): the two launches of namespace ftc's bf16 backward
// (ffn_block_bwd.cu) with fp32 operands, the same tile geometry and the
// same tail plan (tail_plan), so the scratch and the split counters are
// sized as the bf16 route's. It replaces the FMA chain ffn_backward<float>
// at every UNet shape. Included by ffn_block_bwd.cu after the definitions
// it shares (FfnBwdArgs, Tower, tower_floats, TailPlan, BwdArgsT).
//   1. gate_grad_kernel_f32: one block per (64-row tile, 64 hidden
//      columns, tower) recomputes a and b as one 64 x 128 product h @ [wa
//      | wb] (the h tile read once for both; wa's and wb's columns
//      interleaved in 8-column chunks, as block_core's fp32 gate), then dg
//      = g @ wc^T on the same ring (wc [M, C] read in place as a B tile
//      stored [n][k]), and writes da, db and the gate in fp32. Where the
//      grid has fewer blocks than two per SM (batch 1 at C >= 512), k = C
//      is split over blocks (split_k), both products' partials meeting in
//      one split_fixup, dg's as its extra floats. Only the two routed
//      experts' weights are read, found on the card from the
//      device-resident ids.
//   2. tail_kernel_f32, a programmatic dependent launch (it streams h, g
//      and the weights while 1 drains): the nine weight gradients A^T B
//      over the N rows (A = h or the gate, stored [rows][cols] and read
//      as an A_T tile), rows split over blocks where there are fewer tiles
//      than two per SM, the bias gradients as fp32 column sums of the
//      landed da / db tiles carried through split_fixup; and dh as one
//      product over the six segments da_r wa_r^T, db_r wb_r^T (the
//      weights read in place as B tiles stored [n][k]), k split likewise.
// Splits meet in split_fixup in a fixed order: reruns are bitwise equal.
//
// What bounds a call on the H100: the 48 N C M FLOP (3.2 GFLOP at every
// 512px B=1 train shape, 25.8 GFLOP at B=8), three TF32 passes each, so
// operations at 165 TFLOP/s where the FMA chain had 67. fp32 tiles are
// twice bf16's bytes: the gate ring holds 2 k-tiles of 51 KB (A 64 x 68,
// B 64 x 136 floats), 102 KB a block, two blocks per SM (210 registers);
// the dg and tail rings 2 of 34-36 KB, so the tail fits three blocks per
// SM (72 KB, 164 registers), which beat two with 3-deep rings (on the
// H100, cli/trace_kernels.py: 450 against 553 us per B=8 512px tail).
#pragma once

#include "tf32_common.cuh"

namespace ldm {
namespace ftc {

using GateBF = tc::GemmF32<64, 128, 2, 2, 2>;  // h @ [wa | wb], 64 hidden columns
using TileF = tc::GemmF32<64, 64, 2, 2, 2>;    // every other product
static_assert(GateBF::MI == GateG::MI && GateBF::NI == GateG::NI && TileF::MI == Tile::MI &&
                  TileF::NI == Tile::NI && TileF::BM == Tile::BM && TileF::BN == Tile::BN,
              "the bf16 tiles' fragments and plan: for_gate_pairs, for_pairs, tail_plan");
// fp32 per thread of a gate tile's split partial: a and b, then dg
constexpr int GATE_SPLIT_F = (GateBF::MI * GateBF::NI * 4 + TileF::MI * TileF::NI * 4) * THREADS;

struct BwdArgsF : BwdArgsT<float> {
  Split gate;          // the gate's k-tiles (of C) over blocks
  float* gate_part;    // its split partials (after the tail's)
  int* gate_counters;  // one per gate tile (after the tail's)
};

// The gate's split: gate tiles of 64 rows x 64 hidden columns x 3 towers.
inline Split gate_split_f32(int N, int C, int M) {
  return split_k((M / HN) * ((N + GateBF::BM - 1) / GateBF::BM) * 3, C / BK);
}

// Scratch floats of a call: the tail plan's, then the gate's partials.
inline size_t bwd_scratch_floats_f32(int N, int C, int M) {
  const Split g = gate_split_f32(N, C, M);
  const size_t tiles = (size_t)(M / HN) * ((N + GateBF::BM - 1) / GateBF::BM) * 3;
  return tail_plan(N, C, M).floats + (g.splits > 1 ? tiles * g.splits * GATE_SPLIT_F : 0);
}

constexpr size_t kGateSmemF = GateBF::smem_bytes > TileF::smem<false, true>()
                                  ? GateBF::smem_bytes : TileF::smem<false, true>();
constexpr size_t kTailSmemF = TileF::smem<true, false>() > TileF::smem<false, true>()
                                  ? TileF::smem<true, false>() : TileF::smem<false, true>();

// grid (M / 64, ceil(N / 64), 3 towers x gate.splits).
__global__ void __launch_bounds__(THREADS) gate_grad_kernel_f32(BwdArgsF a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  tc::griddep_launch();  // the tail may start streaming h, g and the weights
  const FfnBwdArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int r = blockIdx.z / a.gate.splits, s = blockIdx.z % a.gate.splits;
  const int nbh = blockIdx.x * HN, mb = blockIdx.y * GateBF::BM;
  const int kt = C / BK, kt0 = s * a.gate.per, kt1 = min(kt, kt0 + a.gate.per);
  const Tower<float> w = tower<float>(f, r);
  const float* h = (const float*)f.h;
  const float* g = (const float*)f.g;
  // a's (threads 0-63) and b's (64-127) bias
  __shared__ float bias_s[2 * HN];
  TileBias bias{bias_s, (threadIdx.x < HN ? w.ba : w.bb)[nbh + threadIdx.x % HN]};
  // tile column 16 q + e (a 4-float chunk starts at e = 0, 4, 8, 12) is
  // wa's hidden column 8 q + e for e < 8, wb's 8 q + e - 8 otherwise
  float ab[GateBF::MI][GateBF::NI][4];
  tc::gemm_tile_f32<GateBF>(
      ab, ring, kt0, kt1,
      [&](int rr, int c, int k0) -> const float* {
        return mb + rr < N ? h + (size_t)(mb + rr) * C + k0 + c : nullptr;
      },
      [&](int rr, int c, int k0) -> const float* {
        return ((c & 8) ? w.wb : w.wa) + (size_t)(k0 + rr) * M + nbh + (c >> 4) * 8 + (c & 7);
      },
      [] {});
  // dg = g @ wc^T: B stored [n = hidden column][k = C], wc [M, C] in place
  float dg[TileF::MI][TileF::NI][4];
  tc::gemm_tile_f32<TileF, false, true>(
      dg, ring, kt0, kt1,
      [&](int rr, int c, int k0) -> const float* {
        return mb + rr < N ? g + (size_t)(mb + rr) * C + k0 + c : nullptr;
      },
      [&](int rr, int c, int k0) -> const float* {
        return w.wc + (size_t)(nbh + rr) * C + k0 + c;
      },
      [](const float*, int) {}, [] {});
  bias.share();
  if (a.gate.splits > 1) {
    constexpr int DG = TileF::MI * TileF::NI * 4;
    float ext[DG + 1];
#pragma unroll
    for (int i = 0; i < DG; ++i) ext[i] = dg[i / (TileF::NI * 4)][i / 4 % TileF::NI][i % 4];
    const int tile = (r * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (!tc::split_fixup<THREADS, GateBF::MI, GateBF::NI, DG>(
            ab, ext, a.gate_part + (size_t)tile * a.gate.splits * GATE_SPLIT_F, a.gate.splits, s,
            a.gate_counters + tile))
      return;
#pragma unroll
    for (int i = 0; i < DG; ++i) dg[i / (TileF::NI * 4)][i / 4 % TileF::NI][i % 4] = ext[i];
  }
  const size_t nm = (size_t)N * M;
  float* da = (float*)f.dgate + (size_t)r * nm;
  float* db = (float*)f.dgate + (size_t)(3 + r) * nm;
  float* gate = (float*)f.dgate + (size_t)(6 + r) * nm;
  for_gate_pairs(mb, nbh, [&](int i, int q, int hh, int row, int col) {
    if (row >= N) return;
    float av[2], bv[2], d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      av[e] = ab[i][2 * q][2 * hh + e] + bias.at(0, col - nbh + e);
      bv[e] = ab[i][2 * q + 1][2 * hh + e] + bias.at(1, col - nbh + e);
      d[e] = dg[i][q][2 * hh + e];
    }
    const size_t o = (size_t)row * M + col;
    tc::store2f(da + o, d[0] * fmaxf(bv[0], 0.f), d[1] * fmaxf(bv[1], 0.f));
    tc::store2f(db + o, d[0] * av[0] * (bv[0] > 0.f ? 1.f : 0.f),
                d[1] * av[1] * (bv[1] > 0.f ? 1.f : 0.f));
    tc::store2f(gate + o, av[0] * fmaxf(bv[0], 0.f), av[1] * fmaxf(bv[1], 0.f));
  });
}

// tail_kernel's blocks with fp32 tiles: n_dw blocks of the weight
// gradients z = 3 r + q (q = 0 dwa = h^T da_r (+ dba), 1 dwb = h^T db_r (+
// dbb), 2 dwc = gate_r^T g) in 64 x 64 tiles x `splits` shares of the
// rows; n_dh blocks of dh in 64 x 64 tiles x dh_splits shares of k = 6M.
__global__ void __launch_bounds__(THREADS) tail_kernel_f32(BwdArgsF a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const FfnBwdArgs& f = a.f;
  const TailPlan& p = a.p;
  const int N = f.N, C = f.C, M = f.M;
  const size_t nm = (size_t)N * M;
  const float* dgate = (const float*)f.dgate;
  float acc[TileF::MI][TileF::NI][4];
  const int id = blockIdx.x;
  if (p.dh_first ? id < p.n_dh : id >= p.n_dw) {
    const int b = p.dh_first ? id : id - p.n_dw;
    const int s = b % p.dh_splits, tile = b / p.dh_splits;
    const int mb = (tile / p.dh_tn) * TileF::BM, nb = (tile % p.dh_tn) * TileF::BN;
    const int kt = 6 * M / BK, kt0 = min(kt, s * p.dh_per), kt1 = min(kt, kt0 + p.dh_per);
    // segment z = 2 r + q of k: da_r (q = 0) against wa_r, db_r against wb_r
    const Tower<float> w0 = tower<float>(f, 0), w1 = tower<float>(f, 1), w2 = tower<float>(f, 2);
    auto wseg = [&](int z) {
      const float* wa = z < 2 ? w0.wa : z < 4 ? w1.wa : w2.wa;
      const float* wb = z < 2 ? w0.wb : z < 4 ? w1.wb : w2.wb;
      return (z & 1) ? wb : wa;
    };
    tc::gemm_tile_f32<TileF, false, true>(
        acc, ring, kt0, kt1,
        [&](int rr, int c, int k0) -> const float* {
          const int z = k0 / M;
          return mb + rr < N ? dgate + (size_t)(3 * (z & 1) + (z >> 1)) * nm +
                                   (size_t)(mb + rr) * M + k0 - z * M + c
                             : nullptr;
        },
        [&](int rr, int c, int k0) -> const float* {
          const int z = k0 / M;
          return wseg(z) + (size_t)(nb + rr) * M + k0 - z * M + c;
        },
        [](const float*, int) {}, [] { tc::griddep_wait(); });
    float none[1];
    if (p.dh_splits > 1 &&
        !tc::split_fixup<THREADS, TileF::MI, TileF::NI, 0>(
            acc, none, a.dh_part + (size_t)tile * p.dh_splits * TILE_F, p.dh_splits, s,
            a.counters + p.dh_counter0 + tile))
      return;
    tc::for_pairs<TileF>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
      if (row < N) tc::store2f(a.dh + (size_t)row * C + col, v0, v1);
    });
    return;
  }
  const int b = p.dh_first ? id - p.n_dh : id, s = b % p.splits, tile = b / p.splits;
  const int per_z = p.dw_tiles / 9, z = tile / per_z, r = z / 3, q = z % 3;
  const int ncol = q < 2 ? M : C, tn = ncol / TileF::BN;
  const int mb = ((tile % per_z) / tn) * TileF::BM, nb = (tile % tn) * TileF::BN;
  // A [rows, R] (stored [k][m], an A_T tile), B [rows, ncol]
  const float* A = q < 2 ? (const float*)f.h : dgate + (size_t)(6 + r) * nm;
  const float* B = q < 2 ? dgate + (size_t)(3 * q + r) * nm : (const float*)f.g;
  const int lda = q < 2 ? C : M;
  const int kt = (N + BK - 1) / BK, kt0 = min(kt, s * p.per), kt1 = min(kt, kt0 + p.per);
  auto src_a = [&](int rr, int c, int k0) -> const float* {
    return k0 + rr < N ? A + (size_t)(k0 + rr) * lda + mb + c : nullptr;
  };
  auto src_b = [&](int rr, int c, int k0) -> const float* {
    return k0 + rr < N ? B + (size_t)(k0 + rr) * ncol + nb + c : nullptr;
  };
  // bias gradient (dba, dbb): the tiles of the first row block also sum
  // B's columns in fp32; thread t takes column t % 64 over half the
  // k-tile's rows
  const bool bias = q < 2 && mb == 0;
  float cs[2] = {0.f, 0.f};
  auto col_sums = [&](const float* bs, int ld) {
    if (!bias) return;
    const int col = threadIdx.x % TileF::BN, r0 = (threadIdx.x / TileF::BN) * (BK / 2);
#pragma unroll 8
    for (int rr = 0; rr < BK / 2; ++rr) cs[0] += bs[(r0 + rr) * ld + col];
  };
  auto wait = [] { tc::griddep_wait(); };
  // what the first kernel writes (da, db, the gate) streams after the
  // wait; h or g before it
  if (q < 2)
    tc::gemm_tile_f32<TileF, true, false, true>(acc, ring, kt0, kt1, src_a, src_b, col_sums, wait);
  else
    tc::gemm_tile_f32<TileF, true, false, false>(acc, ring, kt0, kt1, src_a, src_b, col_sums,
                                                 wait);
  if (p.splits > 1 &&
      !tc::split_fixup<THREADS, TileF::MI, TileF::NI, 1>(
          acc, cs, a.part + (size_t)tile * p.splits * (TILE_F + THREADS), p.splits, s,
          a.counters + tile))
    return;
  float* out = a.grads + r * tower_floats(C, M) + (size_t)q * (C + 1) * M;
  tc::for_pairs<TileF>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    tc::store2f(out + (size_t)row * ncol + col, v0, v1);
  });
  if (bias) {
    __shared__ float half[TileF::BN];
    if (threadIdx.x >= TileF::BN) half[threadIdx.x - TileF::BN] = cs[0];
    __syncthreads();
    if (threadIdx.x < TileF::BN) out[(size_t)C * M + nb + threadIdx.x] = cs[0] + half[threadIdx.x];
  }
}

// The two launches (float32, the shapes takes() accepts).
inline int backward_f32(const FfnBwdArgs& f, void* dh, float* grads, float* scratch,
                        int* counters, cudaStream_t st) {
  const TailPlan p = tail_plan(f.N, f.C, f.M);
  const Split gs = gate_split_f32(f.N, f.C, f.M);
  const dim3 ggrid(f.M / HN, (f.N + GateBF::BM - 1) / GateBF::BM, 3 * gs.splits);
  const int gate_tiles = (int)(ggrid.x * ggrid.y * 3);
  if (p.counters + (gs.splits > 1 ? gate_tiles : 0) > kCounters) return (int)cudaErrorInvalidValue;
  BwdArgsF a{};
  static_cast<BwdArgsT<float>&>(a) =
      BwdArgsT<float>{f, p, (float*)dh, grads, scratch, scratch + p.dw_floats, counters};
  a.gate = gs;
  a.gate_part = scratch + p.floats;
  a.gate_counters = counters + p.counters;
  cudaError_t e = tc::launch(gate_grad_kernel_f32, ggrid, kGateSmemF, st,
                             tc::after_previous(false), a);
  if (e != cudaSuccess) return (int)e;
  e = tc::launch(tail_kernel_f32, dim3(p.n_dw + p.n_dh), kTailSmemF, st, tc::after_previous(), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace ftc
}  // namespace ldm
