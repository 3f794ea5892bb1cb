// Tensor-core forward of the SwinBlock FFN (bfloat16 activations), shared
// by ffn_block.cu and block_core.cu: three launches,
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
// split like the towers', so each is summed once), the rings hold 4
// k-tiles (2 in a gate block of at most 2), and 2 and 3 are programmatic
// dependent launches: each streams its first weight (and conv tap) tiles
// while the kernel before it runs, and reads h or g only after
// tc::griddep_wait.
//
// int8 weights (Q; ffn_block_pallas / block_core_pallas(quantized=True)):
// the same launches and plans. The weight k-tiles arrive as int8 and
// become bf16 in shared memory (gemm_tile_q); the gate epilogue gives a
// and b their own column scale and bias before the ReLU (the scale rows
// read in the tile's interleaved order), and the output kernel, whose
// k-loop runs over the three towers, scales each tower's fp32 sum at the
// tower's last k-tile and adds it to a running total, so split-k partials
// arrive already scaled. The conv taps, its bias and the residual stay
// bf16.
#pragma once

#include "ffn_tc.cuh"

namespace ldm {
namespace ftc {

struct FwdArgs {
  FfnArgs f;
  Split gate, out;
  float *gate_part, *out_part;      // fp32 split partials
  int *gate_counters, *out_counters;
  ConvArgs conv;                    // CONV: taps [3, 3, 32, C], bias [C], map H x W
  const void* residual;             // CONV: x, or null
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
// taps [9 * 32, C] (HWIO). gate() as tc::pipeline's: the taps stream
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

// grid (M / 64, ceil(N / 64), 3 towers x gate.splits); a ring of STAGES
// k-tiles. Q: int8 weights with fp32 scale-bias rows.
template <int STAGES, bool Q>
__global__ void __launch_bounds__(THREADS) gate_kernel(FwdArgs a) {
  using G = GateTile<STAGES>;
  using W = typename std::conditional<Q, int8_t, bf16>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::griddep_launch();  // the output kernel may start streaming wc
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int r = blockIdx.z / a.gate.splits, s = blockIdx.z % a.gate.splits;
  const int nbh = blockIdx.x * HN, mb = blockIdx.y * GateG::BM;
  const auto w = reglu_in<bf16, W>(f, r);
  const int kt = C / BK, kt0 = s * a.gate.per, kt1 = min(kt, kt0 + a.gate.per);
  // a's (threads 0-63) and b's (64-127) bias, and with int8 their scale
  __shared__ float bias_s[2 * HN], scale_s[Q ? 2 * HN : 1];
  const auto* ab_bias = threadIdx.x < HN ? w.ba : w.bb;
  const int bc = nbh + threadIdx.x % HN;
  TileBias bias{bias_s, Q ? to_f(ab_bias[M + bc]) : to_f(ab_bias[bc])};
  TileBias scale{scale_s, Q ? to_f(ab_bias[bc]) : 0.f};
  float acc[G::MI][G::NI][4];
  // h comes from norm_film_rows_kernel: the weights stream in before the
  // wait
  if constexpr (Q) {
    const int8_t *wa = w.wa, *wb = w.wb;
    gemm_tile_q<G>(
        acc, smem_raw, kt0, kt1,
        [&](int rr, int c, int k0) -> const bf16* {
          return mb + rr < N ? (const bf16*)f.h + (size_t)(mb + rr) * C + k0 + c : nullptr;
        },
        [&](int rr, int c, int k0) {
          return (c < HN ? wa + c : wb + c - HN) + (size_t)(k0 + rr) * M + nbh;
        },
        // hidden columns c..c+15 of wa (c < 64) or wb: their bf16 tile
        // columns in the 8-column interleave (tile column 16 q + e)
        [](int c) { return c < HN ? make_int2(2 * c, 2 * c + 16) : make_int2(2 * c - 120, 2 * c - 104); },
        [](int) {}, [] { tc::griddep_wait(); });
    scale.share();
  } else {
    ab_tile<G>(acc, reinterpret_cast<bf16*>(smem_raw), (const bf16*)f.h, N, C, M, w.wa, w.wb,
               mb, nbh, kt0, kt1, [] { tc::griddep_wait(); });
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
  bf16* g = (bf16*)f.g + (size_t)r * N * M;
  for_gate_pairs(mb, nbh, [&](int i, int q, int h, int row, int col) {
    if (row >= N) return;
    const int c = col - nbh;
    // (with int8: the fp32 product times the column scale plus the bias,
    // rounded once)
    const auto ab = [&](int which, int e) {
      const float v = acc[i][2 * q + which][2 * h + e];
      return Q ? fmaf(v, scale.at(which, c + e), bias.at(which, c + e)) : v + bias.at(which, c + e);
    };
    const float a0 = ab(0, 0), a1 = ab(0, 1), b0 = ab(1, 0), b1 = ab(1, 1);
    tc::store2(g + (size_t)row * M + col,
               tc::pack_bf16(a0 * fmaxf(b0, 0.f), a1 * fmaxf(b1, 0.f)));
  });
}

// grid (C / 64, ceil(N / 64), out.splits); k-tiles [0, 3M / 64) are the
// towers', then with CONV the 9 conv taps. Q: int8 weights with fp32
// scale-bias rows.
template <bool Q, bool CONV>
__global__ void __launch_bounds__(THREADS) out_kernel(FwdArgs a) {
  using W = typename std::conditional<Q, int8_t, bf16>::type;
  using Bi = typename Wt<bf16, W>::Bias;
  constexpr int BR = Wt<bf16, W>::BR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int nb = blockIdx.x * OutTile::BN, mb = blockIdx.y * OutTile::BM, s = blockIdx.z;
  const size_t mc = (size_t)M * C;
  const W* wc[3] = {(const W*)f.gwc, expert_slice((const W*)f.wc, f.ids, 0, f.E, mc),
                    expert_slice((const W*)f.wc, f.ids, 1, f.E, mc)};
  const Bi* bc[3] = {(const Bi*)f.gbc, expert_slice((const Bi*)f.bc, f.ids, 0, f.E, BR * (size_t)C),
                     expert_slice((const Bi*)f.bc, f.ids, 1, f.E, BR * (size_t)C)};
  const bf16* g = (const bf16*)f.g;
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
    lo = Wt<bf16, W>::bias(bc[0], bcol, C) + Wt<bf16, W>::bias(bc[1], bcol, C) +
         Wt<bf16, W>::bias(bc[2], bcol, C);
    if constexpr (CONV) lo += to_f(((const bf16*)a.conv.bias)[bcol]);
    if constexpr (Q) hi = bc[1][bcol];
  } else if constexpr (Q) {
    lo = bc[0][bcol];
    hi = bc[2][bcol];
  }
  TileBias bias{bias_s, lo}, scales{hi_s, hi};
  float acc[OutTile::MI][OutTile::NI][4];
  // k runs over [g_0 | g_1 | g_2] and [wc_0; wc_1; wc_2]; a k-tile lies in
  // one tower (M % 64 == 0). g comes from gate_kernel: wc streams first.
  const auto src_g = [&](int r, int c, int k0) -> const bf16* {
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
    tc::zero<OutTile::MI, OutTile::NI>(acc);
  } else if constexpr (Q) {
    // each tower's sum in acc, scaled into total at its last k-tile here
    float total[OutTile::MI][OutTile::NI][4];
    tc::zero<OutTile::MI, OutTile::NI>(total);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cn = (warp % OutTile::WN) * (OutTile::BN / OutTile::WN) + 2 * (lane & 3);
    gemm_tile_q<OutTile>(
        acc, smem_raw, kt0, kf1, src_g, src_wc,
        [](int c) { return make_int2(c, c + 8); },
        [&](int k) {
          const int t = k * BK / M;
          if (k + 1 < kf1 && (k + 1) * BK / M == t) return;
#pragma unroll
          for (int i = 0; i < OutTile::MI; ++i)
#pragma unroll
            for (int j = 0; j < OutTile::NI; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = cn + 8 * j + (e & 1);
                total[i][j][e] += acc[i][j][e] * (t == 0 ? bias.at(1, c) : scales.at(t - 1, c));
                acc[i][j][e] = 0.f;
              }
        },
        gate);
#pragma unroll
    for (int i = 0; i < OutTile::MI; ++i)
#pragma unroll
      for (int j = 0; j < OutTile::NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e];
  } else {
    tc::gemm_tile<OutTile, false, false>(acc, reinterpret_cast<bf16*>(smem_raw), kt0, kf1, src_g,
                                         src_wc, [](const bf16*, int) {}, gate);
  }
  if constexpr (CONV) {
    // a split of conv taps alone waits here (its taps stream first)
    if (kt1 > ktf)
      conv_tiles(acc, reinterpret_cast<bf16*>(smem_raw), max(kt0, ktf) - ktf, kt1 - ktf,
                 (const bf16*)f.h, (const bf16*)a.conv.kernel, N, C, a.conv.H, a.conv.W, mb, nb,
                 [&] {
                   if (!towers) gate();
                 });
  }
  if constexpr (!Q) bias.share();
  if (a.out.splits > 1) {
    float none[1];
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (!tc::split_fixup<THREADS, OutTile::MI, OutTile::NI, 0>(
            acc, none, a.out_part + (size_t)tile * a.out.splits * TILE_F, a.out.splits, s,
            a.out_counters + tile))
      return;
  }
  bf16* out = (bf16*)f.out;
  tc::for_pairs<OutTile>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    if (row >= N) return;
    v0 += bias.at(0, col - nb);
    v1 += bias.at(0, col - nb + 1);
    if (CONV && a.residual != nullptr) {
      const __nv_bfloat162 x =
          *reinterpret_cast<const __nv_bfloat162*>((const bf16*)a.residual + (size_t)row * C + col);
      v0 += __low2float(x);
      v1 += __high2float(x);
    }
    tc::store2(out + (size_t)row * C + col, tc::pack_bf16(v0, v1));
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

// Dynamic shared memory of a block of tile G (its ring; with int8
// weights also the converted B tile), and of an output block, whose ring
// the conv k-tiles reuse.
template <bool Q, class G>
constexpr size_t tile_smem() {
  return Q ? QTile<G>::smem : G::template smem<false, false>();
}
template <bool Q>
constexpr size_t out_smem(bool conv) {
  return conv && ConvTile::smem > tile_smem<Q, OutTile>() ? ConvTile::smem
                                                          : tile_smem<Q, OutTile>();
}

// ... of the route's largest launch.
template <bool Q>
constexpr size_t fwd_smem(bool conv) {
  return tile_smem<Q, GateTile<4>>() > out_smem<Q>(conv) ? tile_smem<Q, GateTile<4>>()
                                                         : out_smem<Q>(conv);
}

// The three launches. conv.kernel == nullptr: ffn_block (no conv,
// residual null); else block_core.
template <bool Q>
inline int forward(const FfnArgs& f, const ConvArgs& conv, const void* residual, int* counters,
                   cudaStream_t st) {
  const bool with_conv = conv.kernel != nullptr;
  const FwdPlan p = fwd_plan(f.N, f.C, f.M, with_conv);
  if (p.counters > kCounters) return (int)cudaErrorInvalidValue;
  norm_film_rows_kernel<bf16><<<(f.N * 32 + 255) / 256, 256, 0, st>>>(
      (const bf16*)f.x, (const bf16*)f.mul, (const bf16*)f.bias, f.N, f.C, f.film_rows, 1e-4f,
      (bf16*)f.h);
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
          ? tc::launch(gate_kernel<2, Q>, gate_grid, tile_smem<Q, GateTile<2>>(), st,
                       tc::after_previous(), a)
          : tc::launch(gate_kernel<4, Q>, gate_grid, tile_smem<Q, GateTile<4>>(), st,
                       tc::after_previous(), a);
  if (e != cudaSuccess) return (int)e;
  const dim3 out_grid(f.C / OutTile::BN, p.rt, p.out.splits);
  e = with_conv ? tc::launch(out_kernel<Q, true>, out_grid, out_smem<Q>(true), st,
                             tc::after_previous(), a)
                : tc::launch(out_kernel<Q, false>, out_grid, out_smem<Q>(false), st,
                             tc::after_previous(), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace ftc
}  // namespace ldm
