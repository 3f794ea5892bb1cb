// fp32-accurate products on the H100's tensor cores, for the float32
// routes of block_core and ffn_block, with fp32 or int8 FFN weights
// (ffn_tf32_fwd.cuh), of ffn_block's backward (ffn_tf32_bwd.cuh) and of
// window MHA's forward and backward (window_attention.cu, namespace wtf):
// mma.sync m16n8k8 with TF32 operands and fp32 accumulators, fp32 (or
// int8 weight) tiles streamed through the ring of mma_common.cuh.
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
// product, 3M + 288 deep, up to 3,360 at C = 1024; ffn_block's dh, 6M
// deep, 6,144; a weight gradient's sum over the rows, 32,768 at the B=8
// 512px train step) that is past the fp32 gates' 1e-4. So the passes of
// one k-tile (at most 64 deep: 8 k-steps of 3 passes) go into a zeroed
// fragment, and that partial joins the running sum by an fp32 add on the
// CUDA cores, rounded to nearest (warp_mma_f32).
//
// The error of one product, sum_i x_i y_i over K terms (S = sum_i |x_i
// y_i|), in this model: the split leaves v - hi - lo within 2**-22 |v|,
// so each term's three passes miss it by at most 3 * 2**-22 |x_i y_i|
// (lo*lo and the two tails' roundings; the TF32 products themselves are
// exact in fp32); each of the 3K / 8 mma.sync truncates its partial by
// less than one ulp, 2**-23 S; each of the K / 64 partials and a bias
// join with a rounding of 2**-24 S. In all below (12 + 3K / 4 + K / 64 +
// 1) 2**-24 S, under 2K 2**-24 S = K 2**-23 S for K >= 16: within the
// bound C 2**-23 (|h| |wb| + |bb|) that the ReLU-boundary check of
// ffn_block_bwd (workloads.ffn_bwd_boundary_plain) allows an fp32 sum
// over K = C terms, so that check holds this route unchanged.
//
// Two passes, for int8 weights (the quantized FFN routes). An int8
// weight q is exactly a TF32 value (|q| <= 127 needs 7 bits of
// significand), so it has no tail and a product is lo(a)*q + hi(a)*q:
// each term misses by the activation's split alone, 2**-22 |x_i q_i|;
// the 2K / 8 mma.sync truncate by less than 2**-23 S each; the K / 64
// partials and the bias join rounded. In all below (4 + K / 2 + K / 64 +
// 1) 2**-24 S, under K 2**-23 S for K >= 8: inside the same bound, with
// fewer terms. The column scale then multiplies the fp32 sum, rounded
// once with its bias (fmaf), as the plain version rounds them.
//
// Layouts. An fp32 tile lies in shared memory as in device memory
// (16-byte chunks of 4 floats along the contiguous dimension). The
// fragments are read with 32-bit shared loads: ldmatrix's .trans moves
// 16-bit elements, so it cannot feed a TF32 B fragment from the [in, out]
// weights. Rows are padded so that each load's 32 lanes hit 32 banks:
// with g = lane / 4 and t = lane % 4, an A tile [m][k] is read at (row
// g, column t), so its row stride is 4 mod 32 floats (bank 4 g + t); an
// A tile stored [k][m] (A_T, the weight gradients' A^T) at (row t, column
// g), so 8 mod 32 (bank 8 t + g); a B tile [k][n] at (row t, column g),
// so 8 mod 32; a B tile stored [n][k] at (row g, column t), 4 mod 32. A
// tile read at rows 2 t and 2 t + 1 (a k index taken in pairs, both
// operands alike: window MHA's backward) is padded 4 mod 32 (bank 8 t +
// g).
//
// An int8 B tile [k][n] (frag_b_q) stays int8 in shared memory, a row of
// BN bytes padded by 16, and becomes TF32 at the fragment load: lane (g,
// t) reads the byte at (row k0 + t, column n + g), then (k0 + t + 4, n +
// g), with n a multiple of 8. One load's 32 lanes touch 4 rows (t) of 8
// bytes (g): 2 words a row (lanes sharing a word read it broadcast), 8
// words in all, at word t W + n / 4 and t W + n / 4 + 1 for a row of W
// words. Rows of 144 bytes (W = 36, 4 mod 32: the gate's 128 columns) put
// them in banks b + {0, 1, 4, 5, 8, 9, 12, 13}, rows of 80 (W = 20: the
// output's 64) in b + {0, 1, 20, 21, 8, 9, 28, 29}: 8 banks, no
// conflict (q_rows_conflict_free).
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
// [m][k] (A_T false; ld 4 mod 32) or [k][m] (A_T true; ld 8 mod 32).
template <bool A_T = false>
__device__ __forceinline__ void frag_a_f32(Frag<4>& a, const float* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  if (A_T) {
    const float* p = s + (k0 + t) * ld + m0 + g;
    a.set(0, p[0]);
    a.set(1, p[8]);
    a.set(2, p[4 * ld]);
    a.set(3, p[4 * ld + 8]);
  } else {
    const float* p = s + (m0 + g) * ld + k0 + t;
    a.set(0, p[0]);
    a.set(1, p[8 * ld]);
    a.set(2, p[4]);
    a.set(3, p[8 * ld + 4]);
  }
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
// costs registers where it is large (the FFN tiles). A_T: A stored [k][m].
template <int MI, int NI, bool B_T = false, bool UNROLL = false, bool A_T = false>
__device__ __forceinline__ void warp_mma_f32(float (&acc)[MI][NI][4], const float* As, int lda,
                                             const float* Bs, int ldb, int m0, int n0, int K,
                                             int mt = MI) {
  float part[MI][NI][4];
  zero<MI, NI>(part);
  auto step = [&](int k0) {
    Frag<4> a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      if (i < mt) frag_a_f32<A_T>(a[i], As, lda, m0 + 16 * i, k0);
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
// 64 (as the bf16 tiles', so the split-K plans are shared), or either
// stored the other way round (A_T: [k][m], B_T: [n][k]), rows padded as
// above, a ring of STAGES. A stage of a 64 x 64 tile is 35 KB, twice
// bf16's.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct GemmF32 : Gemm<BM_, BN_, WM_, WN_, STAGES_> {
  static constexpr int LA = BK + 4, LB = BN_ + 8;      // row strides, floats
  static constexpr int LA_T = BM_ + 8, LB_T = BK + 4;  // ... of A_T, B_T tiles
  static constexpr int A_EL = BM_ * LA, STAGE_EL = A_EL + BK * LB;
  static constexpr size_t smem_bytes = 4 * (size_t)STAGES_ * STAGE_EL;
  static_assert(LA % 32 == 4 && LB % 32 == 8 && LB_T % 32 == 4, "conflict-free fragment loads");
  // shared memory of a ring whose tiles are stored as A_T, B_T say
  template <bool A_T, bool B_T>
  __host__ __device__ static constexpr size_t smem() {
    return 4 * (size_t)STAGES_ *
           ((A_T ? BK * LA_T : BM_ * LA) + (B_T ? BN_ * LB_T : BK * LB));
  }
};

// gemm_tile for GemmF32 tiles: acc = A[tile rows, k-tiles kt0..kt1)
// B[.., tile columns]; srcA / srcB(r, c, k0) address the 4 floats at (r,
// c..c+3) of the k-tile at k0 as stored (A_T: [k][m], else [m][k]; B_T:
// [n][k], else [k][n]) or are nullptr. after(Bs, ldb) runs on each landed
// B tile. gate() runs once the first tiles of one operand (B, or A with
// A_FIRST) are in flight and before any copy of the other (pipeline).
template <class G, bool A_T, bool B_T, bool A_FIRST = false, class SrcA, class SrcB, class After,
          class Gate>
__device__ __forceinline__ void gemm_tile_f32(float (&acc)[G::MI][G::NI][4], float* ring, int kt0,
                                              int kt1, SrcA srcA, SrcB srcB, After after,
                                              Gate gate) {
  constexpr int LA = A_T ? G::LA_T : G::LA, LB = B_T ? G::LB_T : G::LB;
  constexpr int AE = (A_T ? BK : G::BM) * LA, SE = AE + (B_T ? G::BN : BK) * LB;
  static_assert(!A_T || LA % 32 == 8, "conflict-free fragment loads of an A_T tile");
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / G::WN) * (G::BM / G::WM), n0 = (warp % G::WN) * (G::BN / G::WN);
  zero<G::MI, G::NI>(acc);
  auto load_b = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile_f32<B_T ? G::BN : BK, B_T ? BK : G::BN, THREADS>(
        ring + buf * SE + AE, LB, B_T ? G::BN : BK, [&](int r, int c) { return srcB(r, c, k0); });
  };
  auto load_a = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile_f32<A_T ? BK : G::BM, A_T ? G::BM : BK, THREADS>(
        ring + buf * SE, LA, A_T ? BK : G::BM, [&](int r, int c) { return srcA(r, c, k0); });
  };
  auto compute = [&](int buf) {
    const float* as = ring + buf * SE;
    warp_mma_f32<G::MI, G::NI, B_T, false, A_T>(acc, as, LA, as + AE, LB, m0, n0, BK);
    after(as + AE, LB);
  };
  if (A_FIRST) pipeline<G::NSTAGE>(kt1 - kt0, load_a, gate, load_b, compute);
  else pipeline<G::NSTAGE>(kt1 - kt0, load_b, gate, load_a, compute);
}

// The same with A [m][k] and B [k][n], nothing run on the landed tiles.
template <class G, class SrcA, class SrcB, class Gate>
__device__ __forceinline__ void gemm_tile_f32(float (&acc)[G::MI][G::NI][4], float* ring, int kt0,
                                              int kt1, SrcA srcA, SrcB srcB, Gate gate) {
  gemm_tile_f32<G, false, false>(acc, ring, kt0, kt1, srcA, srcB, [](const float*, int) {}, gate);
}

__device__ __forceinline__ void store2f(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// ---- int8 weights at fp32 activations: two TF32 passes ----

// An int8 weight read as its byte b (q + 256 for q < 0) -> q as an fp32
// (= TF32) bit pattern: b ^ 0x80 (q + 128, unsigned) goes into the
// mantissa of 2**23, and subtracting 2**23 + 128 leaves q exactly (one
// LOP3 and one FADD; no integer-to-float conversion).
__device__ __forceinline__ uint32_t i8_tf32(uint32_t b) {
  return __float_as_uint(__uint_as_float(0x4B000000u | (b ^ 0x80u)) - 8388736.f);
}

// c += a q in two TF32 passes, the tail first (q exact in TF32).
__device__ __forceinline__ void mma2(float (&c)[4], const Frag<4>& a, uint32_t b0, uint32_t b1) {
  mma1688(c, a.lo, b0, b1);
  mma1688(c, a.hi, b0, b1);
}

// Whether an int8 B tile with rows of `ld` bytes is read by frag_b_q
// without bank conflicts (see the header): the 4 rows' word pairs fall
// in 8 distinct banks.
__host__ __device__ constexpr bool q_rows_conflict_free(int ld) {
  const int w = ld / 4;
  for (int t = 0; t < 4; ++t)
    for (int u = 0; u < t; ++u)
      for (int x = 0; x < 2; ++x)
        for (int y = 0; y < 2; ++y)
          if ((t * w + x) % 32 == (u * w + y) % 32) return false;
  return ld % 16 == 0;
}

// B fragment of the 8 x 8 block at (k0, n0) of an int8 tile stored [k][n]
// with rows of ld bytes (n0 a multiple of 8), as TF32.
__device__ __forceinline__ void frag_b_q(uint32_t (&b)[2], const unsigned char* s, int ld, int k0,
                                         int n0) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  const unsigned char* p = s + (k0 + t) * ld + n0 + g;
  b[0] = i8_tf32(p[0]);
  b[1] = i8_tf32(p[4 * ld]);
}

// warp_mma_f32 with an int8 B tile (A [m][k] fp32, ld 4 mod 32; B [k][n]
// int8, rows of ldb bytes): the warp's n8 block j is stored at column
// col(j). Two passes per k-step into a zeroed partial that joins acc by
// fp32 adds at the end.
template <int MI, int NI, class Col>
__device__ __forceinline__ void warp_mma_f32q(float (&acc)[MI][NI][4], const float* As, int lda,
                                              const unsigned char* Bs, int ldb, int m0, Col col,
                                              int K) {
  float part[MI][NI][4];
  zero<MI, NI>(part);
  for (int k0 = 0; k0 < K; k0 += 8) {
    Frag<4> a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) frag_a_f32(a[i], As, lda, m0 + 16 * i, k0);
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      uint32_t b[2];
      frag_b_q(b, Bs, ldb, k0, col(j));
#pragma unroll
      for (int i = 0; i < MI; ++i) mma2(part[i][j], a[i], b[0], b[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// Shared memory of gemm_tile_f32q for block tile G (a Gemm): a ring of
// G::NSTAGE stages, each an fp32 A k-tile [BM][BK] (rows padded to 4 mod
// 32 floats) and an int8 B k-tile [BK][BN] (rows padded by 16 bytes).
// The B k-tile is a quarter of fp32's bytes: a gate stage (64 x 128) is
// 26.6 KB against GemmF32's 51 KB.
template <class G>
struct QF32 {
  static constexpr int LA = BK + 4;     // A row, floats
  static constexpr int LQ = G::BN + 16;  // B row, bytes
  static constexpr int A_BYTES = 4 * G::BM * LA;
  static constexpr int STAGE = A_BYTES + BK * LQ;
  static constexpr size_t smem = (size_t)G::NSTAGE * STAGE;
  static_assert(LA % 32 == 4 && q_rows_conflict_free(LQ), "conflict-free fragment loads");
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte chunks");
};

// gemm_tile_f32's product with an int8 B: acc = A[tile rows, k-tiles
// kt0..kt1) B[.., tile columns], B's elements exact in TF32. srcA(r, c,
// k0) addresses the 4 floats at (r, c..c+3); srcQ(r, c, k0) the 16 int8
// of B's stored row r, columns c..c+15 (c a multiple of 16); col(j) the
// stored column of the warp's n8 block j (so a tile may interleave two
// matrices); after(kt) runs once k-tile kt's product is in acc; gate() as
// gemm_tile_f32's (B streams first).
template <class G, class SrcA, class SrcQ, class Col, class After, class Gate>
__device__ __forceinline__ void gemm_tile_f32q(float (&acc)[G::MI][G::NI][4], unsigned char* smem,
                                               int kt0, int kt1, SrcA srcA, SrcQ srcQ, Col col,
                                               After after, Gate gate) {
  using L = QF32<G>;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / G::WN) * (G::BM / G::WM);
  zero<G::MI, G::NI>(acc);
  auto a_tile = [&](int buf) { return reinterpret_cast<float*>(smem + buf * L::STAGE); };
  auto q_tile = [&](int buf) { return smem + buf * L::STAGE + L::A_BYTES; };
  auto load_q = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile_i8<BK, G::BN, THREADS>(q_tile(buf), L::LQ, BK,
                                     [&](int r, int c) { return srcQ(r, c, k0); });
  };
  auto load_a = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile_f32<G::BM, BK, THREADS>(a_tile(buf), L::LA, G::BM,
                                      [&](int r, int c) { return srcA(r, c, k0); });
  };
  int kt = kt0;
  auto compute = [&](int buf) {
    warp_mma_f32q<G::MI, G::NI>(acc, a_tile(buf), L::LA, q_tile(buf), L::LQ, m0, col, BK);
    after(kt++);
  };
  pipeline<G::NSTAGE>(kt1 - kt0, load_q, gate, load_a, compute);
}

}  // namespace tc
}  // namespace ldm
