// Fused SwinBlock FFN prologue on rows: (out, h) with
//   h   = channel_norm(x) * film_mul + film_bias
//   out = ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
// The Hopper counterpart of ffn_block_pallas
// (ldm_image_generator_tpu/kernels/ffn_block.py). dtype: 0 = float32,
// 1 = bfloat16; scratch holds ffn_block_scratch_floats(dtype, N, C, M)
// floats, counters ffn_counter_ints() zeroed ints.
//
// bfloat16 at the widths ffn_tc.cuh takes (every UNet shape) runs on the
// tensor cores, three launches:
//   1. norm_film_rows_kernel (ffn_tc.cuh): h, rounded, one row per warp
//      held in registers;
//   2. gate_kernel: one block per (64-row tile, 64 hidden columns, tower)
//      computes a and b together (h tile read once for both) and writes
//      g = T((a + ba) * relu(b + bb)); the expert slices are chosen on the
//      card from the device-resident ids, so only the two selected
//      experts' weights are read;
//   3. out_kernel: out = T(sum_r g_r @ wc_r + gbc + bc_e1 + bc_e2), one
//      k-loop of 3M over the three towers, the biases in the epilogue.
// What bounds a call on the H100: at the B=4 sampling shapes with C >= 512
// (N <= 256 rows), the 9 C x M weight matrices' bytes (4.7-18.9 MB); at
// the larger row counts the 18 N C M FLOP. Against the bytes, k is split
// over blocks until the card has two blocks per SM (tc::split_fixup sums
// the splits, no finishing launch), the rings hold 4 k-tiles (2 in a gate
// block of at most 2), and 2 and 3 are programmatic dependent launches:
// each streams its first weight tiles while the kernel before it runs (1
// and 2 let it start at once). Against the operations, mma.sync at 64 x
// 64 block tiles (64 x 128 for the gate's two products). In practice
// every block runs only 2-8 k-tiles, so the three launches' latency, not
// bytes or FLOP, sets a call's time (PERF.md).
// float32, and bfloat16 at other widths, keep the CUDA-core FMA chain of
// ffn_common.cuh on purpose: TF32 would break the fp32 gates.
//
// int8 weights (wq = 1; ffn_block_pallas(quantized=True)): the same
// launches and plans on either route. On the tensor cores the weight
// k-tiles arrive as int8 and become bf16 in shared memory (gemm_tile_q);
// the gate epilogue gives a and b their own column scale and bias before
// the ReLU (the scale rows read in the tile's interleaved order), and the
// output kernel, whose k-loop runs over the three towers, scales each
// tower's fp32 sum at the tower's last k-tile and adds it to a running
// total, so split-k partials arrive already scaled. The weight bytes
// halve; a call stays bound by the same launch latency (PERF.md).
#include "ffn_tc.cuh"

namespace ldm {
namespace ftc {

struct FwdArgs {
  FfnArgs f;
  Split gate, out;
  float *gate_part, *out_part;      // fp32 split partials
  int *gate_counters, *out_counters;
};

using OutTile = Gemm<64, 64, 2, 2, 4>;

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

// grid (C / 64, ceil(N / 64), out.splits). Q: int8 weights with fp32
// scale-bias rows.
template <bool Q>
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
  const int kt = 3 * M / BK, kt0 = s * a.out.per, kt1 = min(kt, kt0 + a.out.per);
  // threads 0-63: the three output biases' sum; with int8, the towers'
  // column scales: tower 0's in threads 64-127, towers 1 and 2's in hi
  __shared__ float bias_s[2 * HN], hi_s[Q ? 2 * HN : 1];
  const int bcol = nb + threadIdx.x % HN;
  float lo = 0.f, hi = 0.f;
  if (threadIdx.x < HN) {
    lo = Wt<bf16, W>::bias(bc[0], bcol, C) + Wt<bf16, W>::bias(bc[1], bcol, C) +
         Wt<bf16, W>::bias(bc[2], bcol, C);
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
    return wc[t] + (size_t)(k0 - t * M + r) * C + nb + c;
  };
  if constexpr (Q) {
    // each tower's sum in acc, scaled into total at its last k-tile here
    float total[OutTile::MI][OutTile::NI][4];
    tc::zero<OutTile::MI, OutTile::NI>(total);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cn = (warp % OutTile::WN) * (OutTile::BN / OutTile::WN) + 2 * (lane & 3);
    gemm_tile_q<OutTile>(
        acc, smem_raw, kt0, kt1, src_g, src_wc,
        [](int c) { return make_int2(c, c + 8); },
        [&](int k) {
          const int t = k * BK / M;
          if (k + 1 < kt1 && (k + 1) * BK / M == t) return;
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
        [&] {
          bias.share();
          scales.share();
          tc::griddep_wait();
        });
#pragma unroll
    for (int i = 0; i < OutTile::MI; ++i)
#pragma unroll
      for (int j = 0; j < OutTile::NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e];
  } else {
    tc::gemm_tile<OutTile, false, false>(acc, reinterpret_cast<bf16*>(smem_raw), kt0, kt1, src_g,
                                         src_wc, [](const bf16*, int) {},
                                         [] { tc::griddep_wait(); });
    bias.share();
  }
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
    if (row < N)
      tc::store2(out + (size_t)row * C + col,
                 tc::pack_bf16(v0 + bias.at(0, col - nb), v1 + bias.at(0, col - nb + 1)));
  });
}

struct FwdPlan {
  int rt;                   // 64-row tiles
  Split gate, out;
  int gate_tiles, out_tiles;
  size_t gate_floats, floats;  // split partials: the gate's, then in all
  int counters;             // split counters used: the gate's, then the output's
};

inline FwdPlan fwd_plan(int N, int C, int M) {
  FwdPlan p;
  p.rt = (N + Tile::BM - 1) / Tile::BM;
  p.gate_tiles = 3 * p.rt * (M / HN);
  p.out_tiles = p.rt * (C / Tile::BN);
  p.gate = split_k(p.gate_tiles, C / BK);
  p.out = split_k(p.out_tiles, 3 * M / BK);
  p.gate_floats = p.gate.splits > 1 ? (size_t)p.gate_tiles * p.gate.splits * GATE_F : 0;
  p.floats = p.gate_floats + (p.out.splits > 1 ? (size_t)p.out_tiles * p.out.splits * TILE_F : 0);
  p.counters = (p.gate.splits > 1 ? p.gate_tiles : 0) + (p.out.splits > 1 ? p.out_tiles : 0);
  return p;
}

template <bool Q>
inline int forward(const FfnArgs& f, int* counters, cudaStream_t st) {
  const FwdPlan p = fwd_plan(f.N, f.C, f.M);
  if (p.counters > kCounters) return (int)cudaErrorInvalidValue;
  norm_film_rows_kernel<<<(f.N * 32 + 255) / 256, 256, 0, st>>>(
      (const bf16*)f.x, (const bf16*)f.mul, (const bf16*)f.bias, f.N, f.C, f.film_rows, 1e-4f,
      (bf16*)f.h);
  const FwdArgs a{f,
                  p.gate,
                  p.out,
                  f.scratch,
                  f.scratch + p.gate_floats,
                  counters,
                  counters + (p.gate.splits > 1 ? p.gate_tiles : 0)};
  const dim3 gate_grid(f.M / HN, p.rt, 3 * p.gate.splits);
  const auto smem = [](auto g) {
    using G = decltype(g);
    return Q ? QTile<G>::smem : G::template smem<false, false>();
  };
  cudaError_t e =
      p.gate.per <= 2
          ? tc::launch(gate_kernel<2, Q>, gate_grid, smem(GateTile<2>()), st,
                       tc::after_previous(), a)
          : tc::launch(gate_kernel<4, Q>, gate_grid, smem(GateTile<4>()), st,
                       tc::after_previous(), a);
  if (e != cudaSuccess) return (int)e;
  e = tc::launch(out_kernel<Q>, dim3(f.C / OutTile::BN, p.rt, p.out.splits), smem(OutTile()),
                 st, tc::after_previous(), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace ftc
}  // namespace ldm

// fp32 scratch (split partial sums) one call needs, for the wrapper.
extern "C" long long ffn_block_scratch_floats(int dtype, int N, int C, int M) {
  if (ffn_tensor_cores(dtype, N, C, M)) return (long long)ldm::ftc::fwd_plan(N, C, M).floats;
  return ffn_scratch_floats(N, C, M);
}

// wq: 0 = weights in the compute dtype, 1 = int8 weights with fp32
// [2, out] scale-bias rows in place of the biases (ffn_common.cuh).
extern "C" int ffn_block_forward(
    int dtype, int wq, const void* x, const void* mul, const void* bias, int film_rows,
    const void* gwa, const void* gba, const void* gwb, const void* gbb, const void* gwc,
    const void* gbc, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* bc, int E, const void* ids, int N, int C, int M, void* out,
    void* h, void* g, void* scratch, void* counters, void* stream) {
  ldm::FfnArgs a{x,  mul, bias, film_rows,       gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb,
                 bb, wc,  bc,   E, (const int*)ids, N,   C,   M,   out, h,   g,   (float*)scratch};
  const ldm::ConvArgs none{nullptr, nullptr, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ffn_tensor_cores(dtype, N, C, M))
    return wq ? ldm::ftc::forward<true>(a, (int*)counters, st)
              : ldm::ftc::forward<false>(a, (int*)counters, st);
  if (dtype == 0)
    return wq ? ldm::ffn_chain<float, int8_t>(a, none, 1, nullptr, st)
              : ldm::ffn_chain<float, float>(a, none, 1, nullptr, st);
  if (dtype == 1)
    return wq ? ldm::ffn_chain<__nv_bfloat16, int8_t>(a, none, 1, nullptr, st)
              : ldm::ffn_chain<__nv_bfloat16, __nv_bfloat16>(a, none, 1, nullptr, st);
  return (int)cudaErrorInvalidValue;
}
