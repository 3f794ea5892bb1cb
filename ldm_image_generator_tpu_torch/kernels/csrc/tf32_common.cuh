// fp32-accurate products on the H100's tensor cores, for the float32
// routes of block_core (ffn_tf32_fwd.cuh) and of window MHA's forward
// (window_attention.cu, namespace wtf): mma.sync m16n8k8 with TF32
// operands and fp32 accumulators, fp32 tiles streamed through the ring of
// mma_common.cuh.
//
// Three passes. Each fp32 operand v is split into a TF32 head hi =
// rna(v) and tail lo = rna(v - hi) (the rounding of cvt.rna.tf32.f32:
// the tail holds the next 11 bits, so hi + lo is v to about 2**-22 of
// it), and a product is lo*hi + hi*lo + hi*hi, the small terms first. The
// dropped lo*lo is below 2**-22 of each term, about an fp32 product's own
// rounding; vq.cu's scores are computed the same way. The float32 peak
// of the CUDA cores is 67 TFLOP/s; three passes at the tensor cores' 495
// TFLOP/s TF32 rate are 165.
//
// Running sums. The tensor cores add into their fp32 accumulator with
// truncation, so a long k-loop drifts by up to a few 2**-23 of the sum per
// addition: over the deepest product of the ports (block_core's output
// product, 3M + 288 deep, up to 3,360 at C = 1024) that is past the fp32
// gates' 1e-4. So the passes of one k-tile (at most 64 deep: 8 k-steps of
// 3 passes) go into a zeroed fragment, and that partial joins the running
// sum by an fp32 add on the CUDA cores, rounded to nearest
// (warp_mma_f32).
//
// Layouts. An fp32 tile lies in shared memory as in device memory
// (16-byte chunks of 4 floats along the contiguous dimension). The
// fragments are read with 32-bit shared loads: ldmatrix's .trans moves
// 16-bit elements, so it cannot feed a TF32 B fragment from the [in, out]
// weights. Rows are padded so that each load's 32 lanes hit 32 banks:
// with g = lane / 4 and t = lane % 4, an A tile [m][k] is read at (row
// g, column t), so its row stride is 4 mod 32 floats (bank 4 g + t); a B
// tile [k][n] at (row t, column g), so 8 mod 32 (bank 8 t + g); a B tile
// stored [n][k] at (row g, column t), 4 mod 32.
#pragma once

#include "mma_common.cuh"

namespace ldm {
namespace tc {

// v rounded to TF32 (10 mantissa bits) as cvt.rna.tf32.f32 rounds
// (nearest, ties away from zero), in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// N fp32 fragment elements as TF32 heads and tails.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float v) {
    hi[i] = tf32_rna(v);
    lo[i] = tf32_rna(v - __uint_as_float(hi[i]));
  }
};

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 accumulate.
// Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4): a0 (g,
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t +
// 4, g); c as m16n8k16's (c0, c1 at (g, 2t..2t+1), c2, c3 at row g + 8).
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 passes, the tails' cross terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  mma1688(c, a.lo, b.hi[0], b.hi[1]);
  mma1688(c, a.hi, b.lo[0], b.lo[1]);
  mma1688(c, a.hi, b.hi[0], b.hi[1]);
}

// A fragment of the 16 x 8 block at (m0, k0) of an fp32 tile stored
// [m][k] with leading dimension ld (4 mod 32).
__device__ __forceinline__ void frag_a_f32(Frag<4>& a, const float* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  const float* p = s + (m0 + (l >> 2)) * ld + k0 + (l & 3);
  a.set(0, p[0]);
  a.set(1, p[8 * ld]);
  a.set(2, p[4]);
  a.set(3, p[8 * ld + 4]);
}

// B fragment of the 8 x 8 block at (k0, n0) of an fp32 tile stored
// [k][n] (B_T false; ld 8 mod 32) or [n][k] (B_T true; ld 4 mod 32).
template <bool B_T>
__device__ __forceinline__ void frag_b_f32(Frag<2>& b, const float* s, int ld, int k0, int n0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  if (B_T) {
    const float* p = s + (n0 + g) * ld + k0 + t;
    b.set(0, p[0]);
    b.set(1, p[4]);
  } else {
    const float* p = s + (k0 + t) * ld + n0 + g;
    b.set(0, p[0]);
    b.set(1, p[4 * ld]);
  }
}

// acc[i][j] += A[m0 + 16 i.., 0:K] B[0:K, n0 + 8 j..] for i < mt (<= MI),
// K a multiple of 8 (one k-tile): the passes go into a zeroed partial,
// which joins acc by fp32 adds at the end. UNROLL unrolls the k-steps,
// which pays where a warp's tile is small (window MHA's projections) and
// costs registers where it is large (the FFN tiles).
template <int MI, int NI, bool B_T = false, bool UNROLL = false>
__device__ __forceinline__ void warp_mma_f32(float (&acc)[MI][NI][4], const float* As, int lda,
                                             const float* Bs, int ldb, int m0, int n0, int K,
                                             int mt = MI) {
  float part[MI][NI][4];
  zero<MI, NI>(part);
  auto step = [&](int k0) {
    Frag<4> a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      if (i < mt) frag_a_f32(a[i], As, lda, m0 + 16 * i, k0);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      Frag<2> b;
      frag_b_f32<B_T>(b, Bs, ldb, k0, n0 + 8 * j);
#pragma unroll
      for (int i = 0; i < MI; ++i)
        if (i < mt) mma3(part[i][j], a[i], b);
    }
  };
  if constexpr (UNROLL) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8) step(k0);
  } else {
    for (int k0 = 0; k0 < K; k0 += 8) step(k0);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// load_tile for fp32: rows (<= ROWS) x COLS floats (COLS a multiple of
// 4), 16 bytes (4 floats) a copy; src(r, c) addresses elements (r,
// c..c+3) or is nullptr for zeros.
template <int ROWS, int COLS, int THREADS_, typename Src>
__device__ __forceinline__ void load_tile_f32(float* s, int lds, int rows, Src src) {
  constexpr int CH = COLS / 4, RS = THREADS_ / CH;  // rows per pass
  static_assert(RS >= 1, "a tile row fits in one pass of the threads");
  if ((int)threadIdx.x >= RS * CH) return;
  const int c = (threadIdx.x % CH) * 4, r0 = threadIdx.x / CH;
#pragma unroll
  for (int u = 0; u < (ROWS + RS - 1) / RS; ++u) {
    const int r = r0 + u * RS;
    if (r < rows) cp_async16(s + r * lds + c, src(r, c));
  }
}

// Gemm's block tile with fp32 operands: A [m][k] and B [k][n] k-tiles of
// 64 (as the bf16 tiles', so the split-K plans are shared), rows padded
// as above, a ring of STAGES. A stage of a 64 x 64 tile is 35 KB, twice
// bf16's.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct GemmF32 : Gemm<BM_, BN_, WM_, WN_, STAGES_> {
  static constexpr int LA = BK + 4, LB = BN_ + 8;  // row strides, floats
  static constexpr int A_EL = BM_ * LA, STAGE_EL = A_EL + BK * LB;
  static constexpr size_t smem_bytes = 4 * (size_t)STAGES_ * STAGE_EL;
  static_assert(LA % 32 == 4 && LB % 32 == 8, "conflict-free fragment loads");
};

// gemm_tile (A_T, B_T false) for GemmF32 tiles: acc = A[tile rows,
// k-tiles kt0..kt1) B[.., tile columns]; srcA / srcB(r, c, k0) address
// the 4 floats at (r, c..c+3) of the k-tile at k0 or are nullptr. B
// streams first, A after gate() (pipeline).
template <class G, class SrcA, class SrcB, class Gate>
__device__ __forceinline__ void gemm_tile_f32(float (&acc)[G::MI][G::NI][4], float* ring, int kt0,
                                              int kt1, SrcA srcA, SrcB srcB, Gate gate) {
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / G::WN) * (G::BM / G::WM), n0 = (warp % G::WN) * (G::BN / G::WN);
  zero<G::MI, G::NI>(acc);
  auto load_b = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile_f32<BK, G::BN, THREADS>(ring + buf * G::STAGE_EL + G::A_EL, G::LB, BK,
                                      [&](int r, int c) { return srcB(r, c, k0); });
  };
  auto load_a = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile_f32<G::BM, BK, THREADS>(ring + buf * G::STAGE_EL, G::LA, G::BM,
                                      [&](int r, int c) { return srcA(r, c, k0); });
  };
  auto compute = [&](int buf) {
    const float* as = ring + buf * G::STAGE_EL;
    warp_mma_f32<G::MI, G::NI>(acc, as, G::LA, as + G::A_EL, G::LB, m0, n0, BK);
  };
  pipeline<G::NSTAGE>(kt1 - kt0, load_b, gate, load_a, compute);
}

__device__ __forceinline__ void store2f(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

}  // namespace tc
}  // namespace ldm
