// block_core's float32 route on the tensor cores (three TF32 passes,
// tf32_common.cuh): the three launches of ffn_tc_fwd.cuh with fp32
// operands, with the same tile geometry and split-K plans (fwd_plan), so
// the scratch and the split counters are sized as the bf16 route's:
//   1. norm_film_rows_kernel<float>: h in fp32, one row per warp;
//   2. gate_kernel_f32: one block per (64-row tile, 64 hidden columns,
//      tower) computes a and b as one 64 x 128 product (wa's and wb's
//      columns interleaved in 8-column chunks, as the bf16 gate) and
//      writes g = (a + ba) * relu(b + bb); only the two selected experts'
//      weights are read, found on the card from the device-resident ids;
//   3. out_kernel_f32: out = sum_r g_r @ wc_r + the grouped 3x3 conv of h
//      (9 more k-tiles, one per tap, each warp's 32 output columns one
//      group) + the output, conv biases and the residual, written once.
// Splits meet in tc::split_fixup in a fixed order; 2 and 3 are
// programmatic dependent launches that stream their first weight (and
// tap) tiles while the kernel before them runs.
//
// What bounds a call on the H100: at batch 1 and C >= 512 the weight
// bytes (a C = 1024 call streams 37.7 MB: 11 us at 3.35 TB/s), at the
// latent-64 maps with C <= 256 the 18 N C M + 576 N C FLOP, which three
// TF32 passes run at 165 TFLOP/s where the FMA chain had 67. Against the
// bytes, split-K keeps two blocks per SM streaming; against the
// operations, every product is mma.sync. fp32 tiles are twice bf16's
// bytes: a gate stage is 51 KB (A 64 x 68, B 64 x 136 floats) and an
// output stage 35 KB, so the rings hold 2 and 3 k-tiles (102 KB and 105
// KB of the SM's 227 KB: two blocks per SM), against bf16's 4.
// The int8 weights at fp32 activations keep the FMA chain.
#pragma once

#include "ffn_tc_fwd.cuh"
#include "tf32_common.cuh"

namespace ldm {
namespace ftc {

using GateF = tc::GemmF32<64, 128, 2, 2, 2>;  // h @ [wa | wb], 64 hidden columns
using OutF = tc::GemmF32<64, 64, 2, 2, 3>;
static_assert(GateF::MI == GateG::MI && GateF::NI == GateG::NI && OutF::MI == Tile::MI &&
                  OutF::NI == Tile::NI,
              "the bf16 tiles' fragments: split partials, for_gate_pairs, for_pairs");

// The grouped conv's k-tiles (ConvTile's) with fp32 operands: A = h
// shifted by the tap, [64 rows][64 channels]; B = the tap's two diagonal
// 32 x 32 blocks, [64][32].
struct ConvF {
  static constexpr int LA = BK + 4, LB = kGroup + 8;  // row strides, floats
  static constexpr int A_EL = OutF::BM * LA, STAGE_EL = A_EL + BK * LB;
  static constexpr int NSTAGE = OutF::NSTAGE;
  static constexpr size_t smem = 4 * (size_t)NSTAGE * STAGE_EL;
  static_assert(smem <= OutF::smem_bytes, "the conv ring fits in the output ring");
};

// acc += the conv taps [t0, t1) of the output tile at (mb, nb); h [N, C],
// taps [9 * 32, C] (HWIO). gate() as tc::pipeline's: the taps stream
// first, h after it. Each tap's partial joins acc once (warp_mma_f32).
template <class Gate>
__device__ __forceinline__ void conv_tiles_f32(float (&acc)[OutF::MI][OutF::NI][4], float* ring,
                                               int t0, int t1, const float* h, const float* taps,
                                               int N, int C, int H, int W, int mb, int nb,
                                               Gate gate) {
  using L = ConvF;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / OutF::WN) * (OutF::BM / OutF::WM);
  const int n0 = (warp % OutF::WN) * (OutF::BN / OutF::WN);
  // A: this thread copies columns ca..ca+3 of tile rows ra + RS u; each
  // row's pixel (x, y) is found once (y out of range past the last row)
  constexpr int CH = BK / 4, RS = THREADS / CH, RU = OutF::BM / RS;
  const int ca = (threadIdx.x % CH) * 4, ra = threadIdx.x / CH;
  int px[RU], py[RU];
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    const int n = mb + ra + RS * u;
    px[u] = n % W;
    py[u] = n < N ? n / W % H : -2;
  }
  // B: columns cb..cb+3 of rows rb and rb + 16 of each group's block
  constexpr int BCH = kGroup / 4, BRS = THREADS / BCH;
  static_assert(2 * BRS == kGroup, "a group's block in two passes");
  const int cb = (threadIdx.x % BCH) * 4, rb = threadIdx.x / BCH;
  auto load_b = [&](int buf, int i) {
    float* s = ring + buf * L::STAGE_EL + L::A_EL;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = rb + BRS * u;
      const float* src = taps + (size_t)((t0 + i) * kGroup + r) * C + nb + cb;
      tc::cp_async16(s + r * L::LB + cb, src);
      tc::cp_async16(s + (r + kGroup) * L::LB + cb, src + kGroup);
    }
  };
  auto load_a = [&](int buf, int i) {
    const int t = t0 + i, dy = t / 3 - 1, dx = t % 3 - 1;
    float* s = ring + buf * L::STAGE_EL;
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int r = ra + RS * u, x = px[u] + dx, y = py[u] + dy;
      const bool in = x >= 0 && x < W && y >= 0 && y < H;
      tc::cp_async16(s + r * L::LA + ca,
                     in ? h + (size_t)(mb + r + dy * W + dx) * C + nb + ca : nullptr);
    }
  };
  auto compute = [&](int buf) {
    const float* s = ring + buf * L::STAGE_EL;
    tc::warp_mma_f32<OutF::MI, OutF::NI>(acc, s + n0, L::LA, s + L::A_EL + n0 * L::LB, L::LB,
                                         m0, 0, kGroup);
  };
  tc::pipeline<L::NSTAGE>(t1 - t0, load_b, gate, load_a, compute);
}

// grid (M / 64, ceil(N / 64), 3 towers x gate.splits).
__global__ void __launch_bounds__(THREADS) gate_kernel_f32(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::griddep_launch();  // the output kernel may start streaming wc
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int r = blockIdx.z / a.gate.splits, s = blockIdx.z % a.gate.splits;
  const int nbh = blockIdx.x * HN, mb = blockIdx.y * GateF::BM;
  const auto w = reglu_in<float, float>(f, r);
  const int kt = C / BK, kt0 = s * a.gate.per, kt1 = min(kt, kt0 + a.gate.per);
  // a's (threads 0-63) and b's (64-127) bias
  __shared__ float bias_s[2 * HN];
  TileBias bias{bias_s, (threadIdx.x < HN ? w.ba : w.bb)[nbh + threadIdx.x % HN]};
  const float* h = (const float*)f.h;
  float acc[GateF::MI][GateF::NI][4];
  // h comes from norm_film_rows_kernel: the weights stream in before the
  // wait. Tile column 16 q + e (a 4-float chunk starts at e = 0, 4, 8, 12)
  // is wa's hidden column 8 q + e for e < 8, wb's 8 q + e - 8 otherwise.
  tc::gemm_tile_f32<GateF>(
      acc, reinterpret_cast<float*>(smem_raw), kt0, kt1,
      [&](int rr, int c, int k0) -> const float* {
        return mb + rr < N ? h + (size_t)(mb + rr) * C + k0 + c : nullptr;
      },
      [&](int rr, int c, int k0) -> const float* {
        return ((c & 8) ? w.wb : w.wa) + (size_t)(k0 + rr) * M + nbh + (c >> 4) * 8 + (c & 7);
      },
      [] { tc::griddep_wait(); });
  bias.share();
  if (a.gate.splits > 1) {
    float none[1];
    const int tile = (r * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (!tc::split_fixup<THREADS, GateF::MI, GateF::NI, 0>(
            acc, none, a.gate_part + (size_t)tile * a.gate.splits * GATE_F, a.gate.splits, s,
            a.gate_counters + tile))
      return;
  }
  float* g = (float*)f.g + (size_t)r * N * M;
  for_gate_pairs(mb, nbh, [&](int i, int q, int hh, int row, int col) {
    if (row >= N) return;
    const int c = col - nbh;
    const float a0 = acc[i][2 * q][2 * hh] + bias.at(0, c);
    const float a1 = acc[i][2 * q][2 * hh + 1] + bias.at(0, c + 1);
    const float b0 = acc[i][2 * q + 1][2 * hh] + bias.at(1, c);
    const float b1 = acc[i][2 * q + 1][2 * hh + 1] + bias.at(1, c + 1);
    tc::store2f(g + (size_t)row * M + col, a0 * fmaxf(b0, 0.f), a1 * fmaxf(b1, 0.f));
  });
}

// grid (C / 64, ceil(N / 64), out.splits); k-tiles [0, 3M / 64) are the
// towers', then the 9 conv taps.
__global__ void __launch_bounds__(THREADS) out_kernel_f32(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const int nb = blockIdx.x * OutF::BN, mb = blockIdx.y * OutF::BM, s = blockIdx.z;
  const size_t mc = (size_t)M * C;
  const float* wc[3] = {(const float*)f.gwc, expert_slice((const float*)f.wc, f.ids, 0, f.E, mc),
                        expert_slice((const float*)f.wc, f.ids, 1, f.E, mc)};
  const float* bc[3] = {(const float*)f.gbc,
                        expert_slice((const float*)f.bc, f.ids, 0, f.E, (size_t)C),
                        expert_slice((const float*)f.bc, f.ids, 1, f.E, (size_t)C)};
  const float* g = (const float*)f.g;
  // this split's k-tiles [kt0, kt1): the towers' [kt0, kf1), the conv's
  // after them
  const int ktf = 3 * M / BK, kt = ktf + kTaps;
  const int kt0 = s * a.out.per, kt1 = min(kt, kt0 + a.out.per), kf1 = min(kt1, ktf);
  const bool towers = kt0 < kf1;
  // threads 0-63: the three output biases' and the conv bias's sum
  __shared__ float bias_s[2 * HN];
  const int bcol = nb + threadIdx.x % HN;
  TileBias bias{bias_s, threadIdx.x < HN ? bc[0][bcol] + bc[1][bcol] + bc[2][bcol] +
                                               ((const float*)a.conv.bias)[bcol]
                                         : 0.f};
  float acc[OutF::MI][OutF::NI][4];
  // k runs over [g_0 | g_1 | g_2] and [wc_0; wc_1; wc_2]; a k-tile lies in
  // one tower (M % 64 == 0). g comes from gate_kernel_f32: wc streams
  // first.
  if (towers) {
    tc::gemm_tile_f32<OutF>(
        acc, ring, kt0, kf1,
        [&](int r, int c, int k0) -> const float* {
          const int t = k0 / M;
          return mb + r < N ? g + ((size_t)t * N + mb + r) * M + k0 - t * M + c : nullptr;
        },
        [&](int r, int c, int k0) -> const float* {
          const int t = k0 / M;
          // selects, not wc[t]: a runtime index would put wc in local memory
          const float* w = t == 0 ? wc[0] : t == 1 ? wc[1] : wc[2];
          return w + (size_t)(k0 - t * M + r) * C + nb + c;
        },
        [] { tc::griddep_wait(); });
  } else {
    tc::zero<OutF::MI, OutF::NI>(acc);
  }
  // a split of conv taps alone waits here (its taps stream first)
  if (kt1 > ktf)
    conv_tiles_f32(acc, ring, max(kt0, ktf) - ktf, kt1 - ktf, (const float*)f.h,
                   (const float*)a.conv.kernel, N, C, a.conv.H, a.conv.W, mb, nb, [&] {
                     if (!towers) tc::griddep_wait();
                   });
  bias.share();
  if (a.out.splits > 1) {
    float none[1];
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (!tc::split_fixup<THREADS, OutF::MI, OutF::NI, 0>(
            acc, none, a.out_part + (size_t)tile * a.out.splits * TILE_F, a.out.splits, s,
            a.out_counters + tile))
      return;
  }
  float* out = (float*)f.out;
  const float* res = (const float*)a.residual;
  tc::for_pairs<OutF>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    if (row >= N) return;
    v0 += bias.at(0, col - nb);
    v1 += bias.at(0, col - nb + 1);
    if (res != nullptr) {
      const float2 x = *reinterpret_cast<const float2*>(res + (size_t)row * C + col);
      v0 += x.x;
      v1 += x.y;
    }
    tc::store2f(out + (size_t)row * C + col, v0, v1);
  });
}

// Dynamic shared memory of the route's largest launch.
constexpr size_t fwd_smem_f32() {
  return GateF::smem_bytes > OutF::smem_bytes ? GateF::smem_bytes : OutF::smem_bytes;
}

// The three launches (block_core, full-precision fp32 weights).
inline int forward_f32(const FfnArgs& f, const ConvArgs& conv, const void* residual,
                       int* counters, cudaStream_t st) {
  const FwdPlan p = fwd_plan(f.N, f.C, f.M, true);
  if (p.counters > kCounters) return (int)cudaErrorInvalidValue;
  norm_film_rows_kernel<float><<<(f.N * 32 + 255) / 256, 256, 0, st>>>(
      (const float*)f.x, (const float*)f.mul, (const float*)f.bias, f.N, f.C, f.film_rows,
      1e-4f, (float*)f.h);
  const FwdArgs a{f,
                  p.gate,
                  p.out,
                  f.scratch,
                  f.scratch + p.gate_floats,
                  counters,
                  counters + (p.gate.splits > 1 ? p.gate_tiles : 0),
                  conv,
                  residual};
  cudaError_t e = tc::launch(gate_kernel_f32, dim3(f.M / HN, p.rt, 3 * p.gate.splits),
                             GateF::smem_bytes, st, tc::after_previous(), a);
  if (e != cudaSuccess) return (int)e;
  e = tc::launch(out_kernel_f32, dim3(f.C / OutF::BN, p.rt, p.out.splits), OutF::smem_bytes,
                 st, tc::after_previous(), a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace ftc
}  // namespace ldm
