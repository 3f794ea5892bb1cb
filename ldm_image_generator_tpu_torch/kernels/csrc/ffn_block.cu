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
// k-tiles.
template <int STAGES>
__global__ void __launch_bounds__(THREADS) gate_kernel(FwdArgs a) {
  using G = GateTile<STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  tc::griddep_launch();  // the output kernel may start streaming wc
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int r = blockIdx.z / a.gate.splits, s = blockIdx.z % a.gate.splits;
  const int nbh = blockIdx.x * HN, mb = blockIdx.y * GateG::BM;
  const Reglu<bf16> w = reglu_in<bf16>(f, r);
  const int kt = C / BK, kt0 = s * a.gate.per, kt1 = min(kt, kt0 + a.gate.per);
  __shared__ float bias_s[2 * HN];
  TileBias bias{bias_s, to_f((threadIdx.x < HN ? w.ba : w.bb)[nbh + threadIdx.x % HN])};
  float acc[G::MI][G::NI][4];
  // h comes from norm_film_rows_kernel: the weights stream in before the
  // wait
  ab_tile<G>(acc, ring, (const bf16*)f.h, N, C, M, w.wa, w.wb, mb, nbh, kt0, kt1,
             [] { tc::griddep_wait(); });
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
    const float a0 = acc[i][2 * q][2 * h] + bias.at(0, c);
    const float a1 = acc[i][2 * q][2 * h + 1] + bias.at(0, c + 1);
    const float b0 = acc[i][2 * q + 1][2 * h] + bias.at(1, c);
    const float b1 = acc[i][2 * q + 1][2 * h + 1] + bias.at(1, c + 1);
    tc::store2(g + (size_t)row * M + col,
               tc::pack_bf16(a0 * fmaxf(b0, 0.f), a1 * fmaxf(b1, 0.f)));
  });
}

// grid (C / 64, ceil(N / 64), out.splits).
__global__ void __launch_bounds__(THREADS) out_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int nb = blockIdx.x * OutTile::BN, mb = blockIdx.y * OutTile::BM, s = blockIdx.z;
  const size_t mc = (size_t)M * C;
  const bf16* wc0 = (const bf16*)f.gwc;
  const bf16* wc1 = expert_slice((const bf16*)f.wc, f.ids, 0, f.E, mc);
  const bf16* wc2 = expert_slice((const bf16*)f.wc, f.ids, 1, f.E, mc);
  const bf16* g = (const bf16*)f.g;
  const int kt = 3 * M / BK, kt0 = s * a.out.per, kt1 = min(kt, kt0 + a.out.per);
  // the three output biases' sum (threads 0-63)
  __shared__ float bias_s[2 * HN];
  float b = 0.f;
  if (threadIdx.x < OutTile::BN) {
    const int c = nb + threadIdx.x;
    b = to_f(((const bf16*)f.gbc)[c]) +
        to_f(expert_slice((const bf16*)f.bc, f.ids, 0, f.E, (size_t)C)[c]) +
        to_f(expert_slice((const bf16*)f.bc, f.ids, 1, f.E, (size_t)C)[c]);
  }
  TileBias bias{bias_s, b};
  float acc[OutTile::MI][OutTile::NI][4];
  // k runs over [g_0 | g_1 | g_2] and [wc_0; wc_1; wc_2]; a k-tile lies in
  // one tower (M % 64 == 0). g comes from gate_kernel: wc streams first.
  tc::gemm_tile<OutTile, false, false>(
      acc, ring, kt0, kt1,
      [&](int r, int c, int k0) -> const bf16* {
        const int t = k0 / M;
        return mb + r < N ? g + ((size_t)t * N + mb + r) * M + k0 - t * M + c : nullptr;
      },
      [&](int r, int c, int k0) -> const bf16* {
        const int t = k0 / M;
        return (t == 0 ? wc0 : t == 1 ? wc1 : wc2) + (size_t)(k0 - t * M + r) * C + nb + c;
      },
      [](const bf16*, int) {}, [] { tc::griddep_wait(); });
  bias.share();
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
  cudaError_t e =
      p.gate.per <= 2
          ? tc::launch(gate_kernel<2>, gate_grid, GateTile<2>::smem<false, false>(), st,
                       tc::after_previous(), a)
          : tc::launch(gate_kernel<4>, gate_grid, GateTile<4>::smem<false, false>(), st,
                       tc::after_previous(), a);
  if (e != cudaSuccess) return (int)e;
  e = tc::launch(out_kernel, dim3(f.C / OutTile::BN, p.rt, p.out.splits),
                 OutTile::smem<false, false>(), st, tc::after_previous(), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace ftc
}  // namespace ldm

// fp32 scratch (split partial sums) one call needs, for the wrapper.
extern "C" long long ffn_block_scratch_floats(int dtype, int N, int C, int M) {
  if (ffn_tensor_cores(dtype, N, C, M)) return (long long)ldm::ftc::fwd_plan(N, C, M).floats;
  return ffn_scratch_floats(N, C, M);
}

extern "C" int ffn_block_forward(
    int dtype, const void* x, const void* mul, const void* bias, int film_rows,
    const void* gwa, const void* gba, const void* gwb, const void* gbb, const void* gwc,
    const void* gbc, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* bc, int E, const void* ids, int N, int C, int M, void* out,
    void* h, void* g, void* scratch, void* counters, void* stream) {
  ldm::FfnArgs a{x,  mul, bias, film_rows,       gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb,
                 bb, wc,  bc,   E, (const int*)ids, N,   C,   M,   out, h,   g,   (float*)scratch};
  const ldm::ConvArgs none{nullptr, nullptr, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ffn_tensor_cores(dtype, N, C, M)) return ldm::ftc::forward(a, (int*)counters, st);
  if (dtype == 0) return ldm::ffn_chain<float>(a, none, 1, nullptr, st);
  if (dtype == 1) return ldm::ffn_chain<__nv_bfloat16>(a, none, 1, nullptr, st);
  return (int)cudaErrorInvalidValue;
}
