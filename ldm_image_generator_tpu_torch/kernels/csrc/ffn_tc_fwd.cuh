// Tensor-core forward of the SwinBlock FFN, shared by ffn_block.cu and
// block_core.cu, for bfloat16 activations (bf16 mma.sync) and float32
// ones (fp32 accurate TF32 passes: ffn_tf32_fwd.cuh), each with weights
// of its type or int8 ones. Three launches,
//   1. norm_film_rows_kernel (ffn_tc.cuh): h, rounded, one row per warp
//      held in registers;
//   2. gate_kernel: one block per (64-row tile, 64 hidden columns, tower)
//      computes a and b together (h tile read once for both) and writes
//      g = T((a + ba) * relu(b + bb)); the expert slices are chosen on the
//      card from the device-resident ids, so only the two selected
//      experts' weights are read;
//   3. out_kernel: out = T(sum_r g_r @ wc_r + gbc + bc_e1 + bc_e2), one
//      k-loop of 3M over the three towers, the biases in the epilogue.
//      With CONV (block_core) the same k-loop runs on over 9 more k-tiles,
//      the grouped 3x3 conv of h (group width 32) as an implicit product,
//      and the epilogue adds the conv bias and the residual: out is
//      written once, no finishing launch.
// k is split over blocks until the card has two blocks per SM
// (tc::split_fixup sums the splits in a fixed order; the conv k-tiles are
// split like the towers', so each is summed once), the bf16 rings hold 4
// k-tiles (2 in a gate block of at most 2; the fp32 rings:
// ffn_tf32_fwd.cuh), and 2 and 3 are programmatic dependent launches:
// each streams its first weight (and conv tap) tiles while the kernel
// before it runs, and reads h or g only after tc::griddep_wait. Fwd<T>
// gives the kernels their tiles, tile products and stores.
//
// int8 weights (Q; ffn_block_pallas / block_core_pallas(quantized=True)):
// the same launches and plans. The weight k-tiles arrive as int8 and
// become bf16 in shared memory (gemm_tile_q; with fp32 activations TF32
// at the fragment load); the gate epilogue gives a and b their own column
// scale and bias before the ReLU (the scale rows read in the tile's
// interleaved order), and the output kernel, whose k-loop runs over the
// three towers, scales each tower's fp32 sum at the tower's last k-tile
// and adds it to a running total, so split-k partials arrive already
// scaled. The conv taps, its bias and the residual stay in T.
#pragma once

#include "ffn_tf32_fwd.cuh"

namespace ldm {
namespace ftc {

// A TMA tensor map (CUtensorMap's size and alignment), encoded on the host.
struct alignas(64) TmaMap {
  unsigned long long opaque[16];
};
// The tensor maps of the bf16 wgmma route (ffn_wg_fwd.cuh; zero elsewhere):
// the activations h [N, C] and g [3, N, M], the output [N, C], and the
// weights, the stacked experts' [E, rows, cols] as one 3-D map each.
struct WgMaps {
  TmaMap h, gwa, gwb, wa, wb, g, gwc, wc, out;
};

struct FwdArgs {
  FfnArgs f;
  Split gate, out;
  float *gate_part, *out_part;      // fp32 split partials
  int *gate_counters, *out_counters;
  ConvArgs conv;                    // CONV: taps [3, 3, 32, C], bias [C], map H x W
  const void* residual;             // CONV: x, or null
  WgMaps tma;
};

using OutTile = Gemm<64, 64, 2, 2, 4>;

// The grouped conv's k-tiles: tap t = 3 (dy + 1) + dx + 1 is one 64-deep
// k-tile, A = h at (y + dy, x + dx) for the tile's 64 rows and 64 channels
// (zero rows where the tap falls outside the image, so nothing wraps into
// the next image row or image), B = the tap's weights. An OutTile warp
// owns 32 output columns, exactly one group, so it reads only its group's
// 32 channels of A (K = 32) against that group's 32 x 32 block of B; B is
// stored as the tile's two diagonal blocks, [64][32]. The ring reuses the
// output product's shared memory.
constexpr int kTaps = 9;
struct ConvTile {
  static constexpr int LA = BK + 8, LB = kGroup + 8;  // row strides, elements
  static constexpr int A_EL = OutTile::BM * LA, STAGE_EL = A_EL + BK * LB;
  static constexpr int NSTAGE = OutTile::NSTAGE;
  static constexpr size_t smem = 2 * (size_t)NSTAGE * STAGE_EL;
  static_assert(OutTile::BN / OutTile::WN == kGroup, "one group per warp");
  static_assert(BK == 2 * kGroup && OutTile::BN == BK, "a k-tile is the tile's two groups");
};

// acc += the conv taps [t0, t1) of the output tile at (mb, nb); h [N, C],
// taps [9 * 32, C] (HWIO); bf16 operands (fp32: ffn_tf32_fwd.cuh). gate() as tc::pipeline's: the taps stream
// first, h after it.
template <class Gate>
__device__ __forceinline__ void conv_tiles(float (&acc)[OutTile::MI][OutTile::NI][4], bf16* ring,
                                           int t0, int t1, const bf16* h, const bf16* taps,
                                           int N, int C, int H, int W, int mb, int nb,
                                           Gate gate) {
  using L = ConvTile;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / OutTile::WN) * (OutTile::BM / OutTile::WM);
  const int n0 = (warp % OutTile::WN) * (OutTile::BN / OutTile::WN);
  // A: this thread copies columns ca..ca+7 of tile rows ra + RS u; each
  // row's pixel (x, y) is found once (y out of range past the last row)
  constexpr int CH = BK / 8, RS = THREADS / CH, RU = OutTile::BM / RS;
  const int ca = (threadIdx.x % CH) * 8, ra = threadIdx.x / CH;
  int px[RU], py[RU];
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    const int n = mb + ra + RS * u;
    px[u] = n % W;
    py[u] = n < N ? n / W % H : -2;
  }
  // B: rows rb (group 0) and rb + 32 (group 1), columns cb..cb+7
  const int cb = (threadIdx.x % 4) * 8, rb = threadIdx.x / 4;
  static_assert(THREADS == 4 * kGroup, "one pass of B rows per group");
  auto load_b = [&](int buf, int i) {
    bf16* s = ring + buf * L::STAGE_EL + L::A_EL;
    const bf16* src = taps + (size_t)((t0 + i) * kGroup + rb) * C + nb + cb;
    tc::cp_async16(s + rb * L::LB + cb, src);
    tc::cp_async16(s + (rb + kGroup) * L::LB + cb, src + kGroup);
  };
  auto load_a = [&](int buf, int i) {
    const int t = t0 + i, dy = t / 3 - 1, dx = t % 3 - 1;
    bf16* s = ring + buf * L::STAGE_EL;
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int r = ra + RS * u, x = px[u] + dx, y = py[u] + dy;
      const bool in = x >= 0 && x < W && y >= 0 && y < H;
      tc::cp_async16(s + r * L::LA + ca,
                     in ? h + (size_t)(mb + r + dy * W + dx) * C + nb + ca : nullptr);
    }
  };
  auto compute = [&](int buf) {
    const bf16* s = ring + buf * L::STAGE_EL;
    tc::warp_mma<OutTile::MI, OutTile::NI, false, false>(acc, s + n0, L::LA,
                                                         s + L::A_EL + n0 * L::LB, L::LB, m0, 0,
                                                         kGroup);
  };
  tc::pipeline<L::NSTAGE>(t1 - t0, load_b, gate, load_a, compute);
}

template <>
struct Fwd<bf16> {
  template <bool Q, bool SHORT>
  using GateT = GateTile<SHORT ? 2 : 4>;
  template <bool Q>
  using OutT = OutTile;
  // a ring and, with int8 weights, the converted B tile
  template <bool Q, class G>
  static constexpr size_t smem() {
    return Q ? QTile<G>::smem : G::template smem<false, false>();
  }
  static constexpr size_t conv_smem = ConvTile::smem;

  template <class G, class SrcA, class SrcB, class Wait>
  __device__ __forceinline__ static void tile(float (&acc)[G::MI][G::NI][4], unsigned char* smem,
                                              int kt0, int kt1, SrcA srcA, SrcB srcB, Wait wait) {
    tc::gemm_tile<G, false, false>(acc, reinterpret_cast<bf16*>(smem), kt0, kt1, srcA, srcB,
                                   [](const bf16*, int) {}, wait);
  }
  // hidden columns c..c+15 of wa (c < 64) or wb: their bf16 tile columns
  // in the 8-column interleave (tile column 16 q + e)
  template <class G, class SrcA, class SrcQ, class Wait>
  __device__ __forceinline__ static void gate_q(float (&acc)[G::MI][G::NI][4],
                                                unsigned char* smem, int kt0, int kt1, SrcA srcA,
                                                SrcQ srcQ, Wait wait) {
    gemm_tile_q<G>(
        acc, smem, kt0, kt1, srcA, srcQ,
        [](int c) {
          return c < HN ? make_int2(2 * c, 2 * c + 16) : make_int2(2 * c - 120, 2 * c - 104);
        },
        [](int) {}, wait);
  }
  template <class G, class SrcA, class SrcQ, class After, class Wait>
  __device__ __forceinline__ static void out_q(float (&acc)[G::MI][G::NI][4], unsigned char* smem,
                                               int kt0, int kt1, SrcA srcA, SrcQ srcQ,
                                               After after, Wait wait) {
    gemm_tile_q<G>(acc, smem, kt0, kt1, srcA, srcQ, [](int c) { return make_int2(c, c + 8); },
                   after, wait);
  }
  __device__ __forceinline__ static void store2(bf16* p, float v0, float v1) {
    tc::store2(p, tc::pack_bf16(v0, v1));
  }
  __device__ __forceinline__ static float2 load2(const bf16* p) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    return make_float2(__low2float(x), __high2float(x));
  }
};

// grid (M / 64, ceil(N / 64), 3 towers x gate.splits); G the block tile
// (Fwd<T>::GateT). Q: int8 weights with fp32 scale-bias rows.
template <typename T, class G, bool Q>
__global__ void __launch_bounds__(THREADS) gate_kernel(FwdArgs a) {
  using W = typename std::conditional<Q, int8_t, T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::griddep_launch();  // the output kernel may start streaming wc
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int r = blockIdx.z / a.gate.splits, s = blockIdx.z % a.gate.splits;
  const int nbh = blockIdx.x * HN, mb = blockIdx.y * G::BM;
  const auto w = reglu_in<T, W>(f, r);
  const int kt = C / BK, kt0 = s * a.gate.per, kt1 = min(kt, kt0 + a.gate.per);
  // a's (threads 0-63) and b's (64-127) bias, and with int8 their scale
  // (a [2, M] row pair [scale; bias] each)
  __shared__ float bias_s[2 * HN], scale_s[Q ? 2 * HN : 1];
  const auto* ab_bias = threadIdx.x < HN ? w.ba : w.bb;
  const int bc = nbh + threadIdx.x % HN;
  TileBias bias{bias_s, to_f(ab_bias[(Q ? M : 0) + bc])};
  TileBias scale{scale_s, Q ? to_f(ab_bias[bc]) : 0.f};
  const T* h = (const T*)f.h;
  float acc[G::MI][G::NI][4];
  const auto src_h = [&](int rr, int c, int k0) -> const T* {
    return mb + rr < N ? h + (size_t)(mb + rr) * C + k0 + c : nullptr;
  };
  // h comes from norm_film_rows_kernel: the weights stream in before the
  // wait. Tile column 16 q + e is wa's hidden column 8 q + e for e < 8,
  // wb's 8 q + e - 8 otherwise; an int8 tile stores wa's 64 columns, then
  // wb's (16-byte copies of 16 columns), and gate_q interleaves them.
  const auto wait = [] { tc::griddep_wait(); };
  if constexpr (Q) {
    Fwd<T>::template gate_q<G>(
        acc, smem_raw, kt0, kt1, src_h,
        [&](int rr, int c, int k0) {
          return (c < HN ? w.wa + c : w.wb + c - HN) + (size_t)(k0 + rr) * M + nbh;
        },
        wait);
    scale.share();
  } else {
    Fwd<T>::template tile<G>(
        acc, smem_raw, kt0, kt1, src_h,
        [&](int rr, int c, int k0) -> const T* {
          return ((c & 8) ? w.wb : w.wa) + (size_t)(k0 + rr) * M + nbh + (c >> 4) * 8 + (c & 7);
        },
        wait);
  }
  bias.share();
  if (a.gate.splits > 1) {
    float none[1];
    const int tile = (r * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (!tc::split_fixup<THREADS, G::MI, G::NI, 0>(
            acc, none, a.gate_part + (size_t)tile * a.gate.splits * GATE_F, a.gate.splits, s,
            a.gate_counters + tile))
      return;
  }
  T* g = (T*)f.g + (size_t)r * N * M;
  for_gate_pairs(mb, nbh, [&](int i, int q, int hh, int row, int col) {
    if (row >= N) return;
    const int c = col - nbh;
    // (with int8: the fp32 product times the column scale plus the bias,
    // rounded once)
    const auto ab = [&](int which, int e) {
      const float v = acc[i][2 * q + which][2 * hh + e];
      return Q ? fmaf(v, scale.at(which, c + e), bias.at(which, c + e)) : v + bias.at(which, c + e);
    };
    const float a0 = ab(0, 0), a1 = ab(0, 1), b0 = ab(1, 0), b1 = ab(1, 1);
    Fwd<T>::store2(g + (size_t)row * M + col, a0 * fmaxf(b0, 0.f), a1 * fmaxf(b1, 0.f));
  });
}

// grid (C / 64, ceil(N / 64), out.splits); G the block tile
// (Fwd<T>::OutT); k-tiles [0, 3M / 64) are the towers', then with CONV
// the 9 conv taps. Q: int8 weights with fp32 scale-bias rows.
template <typename T, class G, bool Q, bool CONV>
__global__ void __launch_bounds__(THREADS) out_kernel(FwdArgs a) {
  using W = typename std::conditional<Q, int8_t, T>::type;
  using Bi = typename Wt<T, W>::Bias;
  constexpr int BR = Wt<T, W>::BR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int nb = blockIdx.x * G::BN, mb = blockIdx.y * G::BM, s = blockIdx.z;
  const size_t mc = (size_t)M * C;
  const W* wc[3] = {(const W*)f.gwc, expert_slice((const W*)f.wc, f.ids, 0, f.E, mc),
                    expert_slice((const W*)f.wc, f.ids, 1, f.E, mc)};
  const Bi* bc[3] = {(const Bi*)f.gbc, expert_slice((const Bi*)f.bc, f.ids, 0, f.E, BR * (size_t)C),
                     expert_slice((const Bi*)f.bc, f.ids, 1, f.E, BR * (size_t)C)};
  const T* g = (const T*)f.g;
  // this split's k-tiles [kt0, kt1): the towers' [kt0, kf1), the conv's
  // after them
  const int ktf = 3 * M / BK, kt = ktf + (CONV ? kTaps : 0);
  const int kt0 = s * a.out.per, kt1 = min(kt, kt0 + a.out.per), kf1 = min(kt1, ktf);
  const bool towers = kt0 < kf1;
  // threads 0-63: the three output biases' sum (with CONV, the conv bias
  // too); with int8, the towers' column scales: tower 0's in threads
  // 64-127, towers 1 and 2's in hi
  __shared__ float bias_s[2 * HN], hi_s[Q ? 2 * HN : 1];
  const int bcol = nb + threadIdx.x % HN;
  float lo = 0.f, hi = 0.f;
  if (threadIdx.x < HN) {
    lo = Wt<T, W>::bias(bc[0], bcol, C) + Wt<T, W>::bias(bc[1], bcol, C) +
         Wt<T, W>::bias(bc[2], bcol, C);
    if constexpr (CONV) lo += to_f(((const T*)a.conv.bias)[bcol]);
    if constexpr (Q) hi = bc[1][bcol];
  } else if constexpr (Q) {
    lo = bc[0][bcol];
    hi = bc[2][bcol];
  }
  TileBias bias{bias_s, lo}, scales{hi_s, hi};
  float acc[G::MI][G::NI][4];
  // k runs over [g_0 | g_1 | g_2] and [wc_0; wc_1; wc_2]; a k-tile lies in
  // one tower (M % 64 == 0). g comes from gate_kernel: wc streams first.
  const auto src_g = [&](int r, int c, int k0) -> const T* {
    const int t = k0 / M;
    return mb + r < N ? g + ((size_t)t * N + mb + r) * M + k0 - t * M + c : nullptr;
  };
  const auto src_wc = [&](int r, int c, int k0) {
    const int t = k0 / M;
    // selects, not wc[t]: a runtime index would put wc in local memory
    const W* w = t == 0 ? wc[0] : t == 1 ? wc[1] : wc[2];
    return w + (size_t)(k0 - t * M + r) * C + nb + c;
  };
  // what must precede reading g or h (and, with int8, the tower loop)
  const auto gate = [&] {
    if constexpr (Q) {
      bias.share();
      scales.share();
    }
    tc::griddep_wait();
  };
  if (!towers) {
    tc::zero<G::MI, G::NI>(acc);
  } else if constexpr (Q) {
    // each tower's sum in acc, scaled into total at its last k-tile here
    float total[G::MI][G::NI][4];
    tc::zero<G::MI, G::NI>(total);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cn = (warp % G::WN) * (G::BN / G::WN) + 2 * (lane & 3);
    Fwd<T>::template out_q<G>(
        acc, smem_raw, kt0, kf1, src_g, src_wc,
        [&](int k) {
          const int t = k * BK / M;
          if (k + 1 < kf1 && (k + 1) * BK / M == t) return;
#pragma unroll
          for (int i = 0; i < G::MI; ++i)
#pragma unroll
            for (int j = 0; j < G::NI; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = cn + 8 * j + (e & 1);
                total[i][j][e] += acc[i][j][e] * (t == 0 ? bias.at(1, c) : scales.at(t - 1, c));
                acc[i][j][e] = 0.f;
              }
        },
        gate);
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int j = 0; j < G::NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e];
  } else {
    Fwd<T>::template tile<G>(acc, smem_raw, kt0, kf1, src_g, src_wc, gate);
  }
  if constexpr (CONV) {
    // a split of conv taps alone waits here (its taps stream first)
    if (kt1 > ktf)
      conv_tiles(acc, reinterpret_cast<T*>(smem_raw), max(kt0, ktf) - ktf, kt1 - ktf,
                 (const T*)f.h, (const T*)a.conv.kernel, N, C, a.conv.H, a.conv.W, mb, nb, [&] {
                   if (!towers) gate();
                 });
  }
  if constexpr (!Q) bias.share();
  if (a.out.splits > 1) {
    float none[1];
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (!tc::split_fixup<THREADS, G::MI, G::NI, 0>(
            acc, none, a.out_part + (size_t)tile * a.out.splits * TILE_F, a.out.splits, s,
            a.out_counters + tile))
      return;
  }
  T* out = (T*)f.out;
  const T* res = (const T*)a.residual;
  tc::for_pairs<G>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    if (row >= N) return;
    v0 += bias.at(0, col - nb);
    v1 += bias.at(0, col - nb + 1);
    if (CONV && res != nullptr) {
      const float2 x = Fwd<T>::load2(res + (size_t)row * C + col);
      v0 += x.x;
      v1 += x.y;
    }
    Fwd<T>::store2(out + (size_t)row * C + col, v0, v1);
  });
}

struct FwdPlan {
  int rt;                   // 64-row tiles
  Split gate, out;
  int gate_tiles, out_tiles;
  size_t gate_floats, floats;  // split partials: the gate's, then in all
  int counters;             // split counters used: the gate's, then the output's
};

// conv: the output product carries the conv taps (block_core)
inline FwdPlan fwd_plan(int N, int C, int M, bool conv) {
  FwdPlan p;
  p.rt = (N + Tile::BM - 1) / Tile::BM;
  p.gate_tiles = 3 * p.rt * (M / HN);
  p.out_tiles = p.rt * (C / Tile::BN);
  p.gate = split_k(p.gate_tiles, C / BK);
  p.out = split_k(p.out_tiles, 3 * M / BK + (conv ? kTaps : 0));
  p.gate_floats = p.gate.splits > 1 ? (size_t)p.gate_tiles * p.gate.splits * GATE_F : 0;
  p.floats = p.gate_floats + (p.out.splits > 1 ? (size_t)p.out_tiles * p.out.splits * TILE_F : 0);
  p.counters = (p.gate.splits > 1 ? p.gate_tiles : 0) + (p.out.splits > 1 ? p.out_tiles : 0);
  return p;
}

// Dynamic shared memory of an output block (its ring also holds the conv
// k-tiles), and of the route's largest launch.
template <typename T, bool Q>
constexpr size_t out_smem(bool conv) {
  using F = Fwd<T>;
  constexpr size_t tile = F::template smem<Q, typename F::template OutT<Q>>();
  return conv && F::conv_smem > tile ? F::conv_smem : tile;
}
template <typename T, bool Q>
constexpr size_t fwd_smem(bool conv) {
  using F = Fwd<T>;
  constexpr size_t gate = F::template smem<Q, typename F::template GateT<Q, false>>();
  return gate > out_smem<T, Q>(conv) ? gate : out_smem<T, Q>(conv);
}

// The three launches. conv.kernel == nullptr: ffn_block (no conv,
// residual null); else block_core. T: the activations' type; Q: int8 FFN
// weights.
template <typename T, bool Q>
inline int forward(const FfnArgs& f, const ConvArgs& conv, const void* residual, int* counters,
                   cudaStream_t st) {
  using F = Fwd<T>;
  using Short = typename F::template GateT<Q, true>;
  using Long = typename F::template GateT<Q, false>;
  using O = typename F::template OutT<Q>;
  const bool with_conv = conv.kernel != nullptr;
  const FwdPlan p = fwd_plan(f.N, f.C, f.M, with_conv);
  if (p.counters > kCounters) return (int)cudaErrorInvalidValue;
  norm_film_rows_kernel<T><<<(f.N * 32 + 255) / 256, 256, 0, st>>>(
      (const T*)f.x, (const T*)f.mul, (const T*)f.bias, f.N, f.C, f.film_rows, 1e-4f, (T*)f.h);
  const FwdArgs a{f,
                  p.gate,
                  p.out,
                  f.scratch,
                  f.scratch + p.gate_floats,
                  counters,
                  counters + (p.gate.splits > 1 ? p.gate_tiles : 0),
                  conv,
                  residual};
  const dim3 gate_grid(f.M / HN, p.rt, 3 * p.gate.splits);
  cudaError_t e =
      p.gate.per <= 2
          ? tc::launch(gate_kernel<T, Short, Q>, gate_grid, F::template smem<Q, Short>(), st,
                       tc::after_previous(), a)
          : tc::launch(gate_kernel<T, Long, Q>, gate_grid, F::template smem<Q, Long>(), st,
                       tc::after_previous(), a);
  if (e != cudaSuccess) return (int)e;
  const dim3 out_grid(f.C / O::BN, p.rt, p.out.splits);
  e = with_conv ? tc::launch(out_kernel<T, O, Q, true>, out_grid, out_smem<T, Q>(true), st,
                             tc::after_previous(), a)
                : tc::launch(out_kernel<T, O, Q, false>, out_grid, out_smem<T, Q>(false), st,
                             tc::after_previous(), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace ftc
}  // namespace ldm
