// The float32 side of the forward kernels of ffn_tc_fwd.cuh (block_core
// and ffn_block on the tensor cores): their block tiles, the grouped
// conv's k-tiles and the tile products with fp32 activations, which
// Fwd<float> hands to the kernels. The launches, the tile geometry and
// the split-K plans (fwd_plan) are the bf16 route's, so the scratch and
// the split counters are sized alike.
//
// fp32 weights: every product three TF32 passes (tf32_common.cuh). int8
// weights (ffn_block_pallas / block_core_pallas(quantized=True)): the
// weight k-tiles stream through the ring as int8, a quarter of fp32's
// bytes, and become TF32 at the fragment load (frag_b_q), so each tower
// product takes two passes, lo(a) q + hi(a) q; the column scales and the
// per-tower running total are the bf16 route's (ffn_tc_fwd.cuh's rounding
// points). The conv taps, its bias and the residual stay fp32, three
// passes (conv_tiles).
//
// What bounds a call on the H100: at batch 1 and C >= 512 the weight
// bytes (a C = 1024 block_core call streams 37.7 MB of fp32 weights, 9.4
// MB of int8: 11 and 2.8 us at 3.35 TB/s), at the latent-64 maps with C
// <= 256 and at B=4 the 18 N C M + 576 N C FLOP, which three TF32 passes
// run at 165 TFLOP/s and two at 248, where the FMA chain had 67. Against
// the bytes, split-K keeps two blocks per SM streaming; against the
// operations, every product is mma.sync. An fp32 gate stage is 51 KB (A
// 64 x 68, B 64 x 136 floats) and an output stage 35 KB, so those rings
// hold 2 and 3 k-tiles (102 KB and 105 KB of the SM's 227 KB: two
// blocks per SM); an int8 gate stage is 26.6 KB (B: 64 rows of 128 + 16
// bytes) and an output stage 22.5 KB. The int8 gate's 194 registers
// allow two blocks per SM at any depth, its output kernel's 156 three,
// which a 3-deep ring (67.6 KB) lets in and a 4-deep one (90 KB) does
// not: both int8 rings hold 3 k-tiles (tried on the H100 with
// cli/trace_kernels.py at the 512px shapes, PERF.md §6: 2 and 3 stages
// alike, 4 about 9% slower at B=4; block_core's int8 output ring is its
// conv ring's 83 KB at 2 or 3 stages, two blocks per SM).
#pragma once

#include "ffn_tc.cuh"
#include "tf32_common.cuh"

namespace ldm {
namespace ftc {

using GateF = tc::GemmF32<64, 128, 2, 2, 2>;  // h @ [wa | wb], 64 hidden columns
using OutF = tc::GemmF32<64, 64, 2, 2, 3>;
// ... with int8 weights (the rings of tc::QF32)
using GateQF = tc::Gemm<64, 128, 2, 2, 3>;
using OutQF = tc::Gemm<64, 64, 2, 2, 3>;
static_assert(GateF::MI == GateG::MI && GateF::NI == GateG::NI && OutF::MI == Tile::MI &&
                  OutF::NI == Tile::NI && GateQF::MI == GateG::MI && GateQF::NI == GateG::NI &&
                  OutQF::MI == Tile::MI && OutQF::NI == Tile::NI,
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

// conv_tiles (ffn_tc_fwd.cuh) with fp32 operands: acc += the conv taps
// [t0, t1) of the output tile at (mb, nb); h [N, C], taps [9 * 32, C]
// (HWIO). gate() as tc::pipeline's: the taps stream first, h after it.
// Each tap's partial joins acc once (warp_mma_f32).
template <class Gate>
__device__ __forceinline__ void conv_tiles(float (&acc)[OutF::MI][OutF::NI][4], float* ring,
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

// What the forward kernels (ffn_tc_fwd.cuh) take from the activation
// type T: GateT<Q, SHORT> and OutT<Q>, the block tiles (rings) of the
// gate and the output product (SHORT: each gate block runs at most 2
// k-tiles; Q: int8 weights); smem<Q, G>(), a tile's dynamic shared
// memory, and conv_smem, the conv k-tiles'; tile(), acc = A B over
// k-tiles [kt0, kt1) with A [m][k] and B [k][n] of T; gate_q() and
// out_q(), the same with B an int8 k-tile (srcQ(r, c, k0): the 16 bytes
// of stored row r from column c), the gate's storing wa's 64 columns,
// then wb's, an output tile's in order, after(kt) run once k-tile kt is
// in acc; store2() and load2(), two adjacent elements.
template <typename T>
struct Fwd;

template <>
struct Fwd<float> {
  template <bool Q, bool SHORT>
  using GateT = typename std::conditional<Q, GateQF, GateF>::type;
  template <bool Q>
  using OutT = typename std::conditional<Q, OutQF, OutF>::type;
  template <bool Q, class G>
  static constexpr size_t smem() {
    return Q ? tc::QF32<G>::smem : G::template smem<false, false>();
  }
  static constexpr size_t conv_smem = ConvF::smem;

  template <class G, class SrcA, class SrcB, class Wait>
  __device__ __forceinline__ static void tile(float (&acc)[G::MI][G::NI][4], unsigned char* smem,
                                              int kt0, int kt1, SrcA srcA, SrcB srcB, Wait wait) {
    tc::gemm_tile_f32<G>(acc, reinterpret_cast<float*>(smem), kt0, kt1, srcA, srcB, wait);
  }
  // the interleave is in the fragments' columns: the warp's n8 block j
  // is tile block jj = n0 / 8 + j, stored at wa's or wb's (jj & 1)
  // column 8 (jj >> 1)
  template <class G, class SrcA, class SrcQ, class Wait>
  __device__ __forceinline__ static void gate_q(float (&acc)[G::MI][G::NI][4],
                                                unsigned char* smem, int kt0, int kt1, SrcA srcA,
                                                SrcQ srcQ, Wait wait) {
    const int n0 = (threadIdx.x >> 5) % G::WN * (G::BN / G::WN);
    tc::gemm_tile_f32q<G>(
        acc, smem, kt0, kt1, srcA, srcQ,
        [&](int j) {
          const int jj = n0 / 8 + j;
          return (jj & 1) * HN + (jj >> 1) * 8;
        },
        [](int) {}, wait);
  }
  template <class G, class SrcA, class SrcQ, class After, class Wait>
  __device__ __forceinline__ static void out_q(float (&acc)[G::MI][G::NI][4], unsigned char* smem,
                                               int kt0, int kt1, SrcA srcA, SrcQ srcQ,
                                               After after, Wait wait) {
    const int n0 = (threadIdx.x >> 5) % G::WN * (G::BN / G::WN);
    tc::gemm_tile_f32q<G>(acc, smem, kt0, kt1, srcA, srcQ, [&](int j) { return n0 + 8 * j; },
                          after, wait);
  }
  __device__ __forceinline__ static void store2(float* p, float v0, float v1) {
    tc::store2f(p, v0, v1);
  }
  __device__ __forceinline__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

}  // namespace ftc
}  // namespace ldm
