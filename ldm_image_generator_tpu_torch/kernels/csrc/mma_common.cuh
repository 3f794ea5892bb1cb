// bf16 tensor-core building blocks for the port's Hopper kernels:
// mma.sync.aligned.m16n8k16 (bf16 inputs, fp32 accumulators), operand
// fragments by ldmatrix from shared memory, and a ring of cp.async
// stages of 16-byte copies that keeps several k-tiles in flight.
//
// Why mma.sync and not wgmma: the window-attention products have 16-64
// rows per block (one window, or a 16-row map at batch 1); wgmma needs
// 64-row warpgroup tiles, mma.sync takes 16. What bounds the small-row
// products is the weight stream from device memory, so the ring's depth
// (bytes in flight per SM), not the instruction, sets their speed. That
// holds for window attention and for the FFN kernels at small row counts;
// ffn_block's bf16 forward at thousands of rows, bound by its FLOP, runs
// on wgmma (ffn_wg_fwd.cuh), its bf16 weights fed as they lie (wgmma takes
// a 16-bit B operand MN-major; only tf32, fp8 and int8 need K-major).
//
// Gemm and gemm_tile below are the block-tile products of the weight
// projections (window MHA's output projection and backward tail, the FFN
// kernels of ffn_tc.cuh): a 4-warp block's BM x BN tile over 64-deep
// k-tiles, with split_fixup for split-K.
//
// Layouts. A tile is copied into shared memory as it lies in device
// memory (16-byte chunks along the contiguous dimension), with rows
// padded by 8 elements (16 bytes) so that the eight row addresses of an
// ldmatrix fall in different banks. The fragment loaders take the stored
// orientation as a template flag and pick ldmatrix or ldmatrix.trans:
//   A (M x K): stored [m][k] (A_T false) or [k][m] (A_T true);
//   B (K x N): stored [k][n] (B_T false) or [n][k] (B_T true).
// Fragment layouts are those of the PTX ISA for m16n8k16: with g =
// lane / 4 and t = lane % 4, accumulator c[0..1] holds (row g, columns
// 2t, 2t+1) and c[2..3] (row g + 8, the same columns).
#pragma once

#include "common.cuh"

namespace ldm {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A valid global address for copies that read nothing.
__device__ uint4 g_no_source;

// 16 bytes from src into shared memory at dst, asynchronously; a null src
// writes zeros (padding rows and columns, k past the end), through the
// copy's source size, so the caller does not branch.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src != nullptr ? src : (const void*)&g_no_source), "r"(src != nullptr ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of the 16 x 16 block at (m0, k0) of a tile stored with
// leading dimension ld (elements).
template <bool A_T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3, r = l & 7;
  if (A_T) ldsm_x4_t(a, s + (k0 + r + (mi >> 1) * 8) * ld + m0 + (mi & 1) * 8);
  else ldsm_x4(a, s + (m0 + r + (mi & 1) * 8) * ld + k0 + (mi >> 1) * 8);
}

// B fragments of two 16 x 8 blocks at k0, columns n0.. and n0 + 8..:
// b[0], b[1] for the first, b[2], b[3] for the second.
template <bool B_T>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const bf16* s, int ld, int k0, int n0) {
  const int l = threadIdx.x & 31, mi = l >> 3, r = l & 7;
  if (B_T) ldsm_x4(b, s + (n0 + r + (mi >> 1) * 8) * ld + k0 + (mi & 1) * 8);
  else ldsm_x4_t(b, s + (k0 + r + (mi & 1) * 8) * ld + n0 + (mi >> 1) * 8);
}

// B fragment of one 16 x 8 block (lanes 16-31 repeat 0-15's addresses).
template <bool B_T>
__device__ __forceinline__ void frag_b1(uint32_t (&b)[2], const bf16* s, int ld, int k0, int n0) {
  const int l = threadIdx.x & 15, mi = l >> 3, r = l & 7;
  if (B_T) ldsm_x2(b, s + (n0 + r) * ld + k0 + mi * 8);
  else ldsm_x2_t(b, s + (k0 + r + mi * 8) * ld + n0);
}

// acc[i][j] += A[m0 + 16 i.., 0:K] B[0:K, n0 + 8 j..] for i < mt (<= MI),
// with K a multiple of 16; NI n8 blocks per warp.
template <int MI, int NI, bool A_T, bool B_T>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4], const bf16* As, int lda,
                                         const bf16* Bs, int ldb, int m0, int n0, int K,
                                         int mt = MI) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      if (i < mt) frag_a<A_T>(a[i], As, lda, m0 + 16 * i, k0);
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      if (j + 1 < NI) {
        uint32_t b[4];
        frag_b2<B_T>(b, Bs, ldb, k0, n0 + 8 * j);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i >= mt) continue;
          mma16816(acc[i][j], a[i], b[0], b[1]);
          mma16816(acc[i][j + 1], a[i], b[2], b[3]);
        }
      } else {
        uint32_t b[2];
        frag_b1<B_T>(b, Bs, ldb, k0, n0 + 8 * j);
#pragma unroll
        for (int i = 0; i < MI; ++i)
          if (i < mt) mma16816(acc[i][j], a[i], b[0], b[1]);
      }
    }
  }
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Copy rows (<= ROWS) x COLS elements (COLS a multiple of 8) into shared
// memory at s (leading dimension lds) with THREADS threads, 16 bytes a
// copy; src(r, c) is the address of elements (r, c..c+7) or nullptr for
// zeros. Each thread keeps one 8-column chunk and steps down the rows, so
// the loop unrolls and src's column part is computed once.
template <int ROWS, int COLS, int THREADS, typename Src>
__device__ __forceinline__ void load_tile(bf16* s, int lds, int rows, Src src) {
  constexpr int CH = COLS / 8, RS = THREADS / CH;  // rows per pass
  static_assert(RS >= 1, "a tile row fits in one pass of the threads");
  if ((int)threadIdx.x >= RS * CH) return;
  const int c = (threadIdx.x % CH) * 8, r0 = threadIdx.x / CH;
#pragma unroll
  for (int u = 0; u < (ROWS + RS - 1) / RS; ++u) {
    const int r = r0 + u * RS;
    if (r < rows) cp_async16(s + r * lds + c, src(r, c));
  }
}

// load_tile for int8: rows (<= ROWS) x COLS bytes (COLS a multiple of
// 16), copied as COLS / 2 bf16-sized elements; s's rows are lds bytes,
// src(r, c) addresses bytes (r, c..c+15) or is nullptr for zeros.
template <int ROWS, int COLS, int THREADS, typename Src>
__device__ __forceinline__ void load_tile_i8(unsigned char* s, int lds, int rows, Src src) {
  load_tile<ROWS, COLS / 2, THREADS>(
      reinterpret_cast<bf16*>(s), lds / 2, rows,
      [&](int r, int c) { return reinterpret_cast<const bf16*>(src(r, 2 * c)); });
}

// Programmatic dependent launch (Hopper): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it on the stream still runs, once every block of that one
// has called launch_dependents; it must call wait before touching what the
// earlier kernel writes. wait returns at once in a kernel launched
// without the attribute.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// The k-loop over k-tiles [0, ktiles) with a ring of STAGES buffers:
// pre(buf, kt) and post(buf, kt) issue the copies of k-tile kt into buffer
// buf (two operands), and compute(buf) consumes a landed buffer. STAGES - 1
// tiles are in flight while one is consumed. The first stages' pre copies
// are issued before gate() runs and their post copies after it, so an
// operand that does not depend on the previous kernel (pre: the weights)
// streams in while gate waits for that kernel. Ends with every copy landed
// and a barrier, so the ring's memory may be reused.
template <int STAGES, typename Pre, typename Gate, typename Post, typename Compute>
__device__ __forceinline__ void pipeline(int ktiles, Pre pre, Gate gate, Post post,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < ktiles) pre(s, s);
  gate();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) post(s, s);
    cp_commit();  // group s: stage s (and, for s = 0, every early pre copy)
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed for all; buffer (kt - 1) % STAGES free
    const int nxt = kt + STAGES - 1;
    if (nxt < ktiles) {
      pre(nxt % STAGES, nxt);
      post(nxt % STAGES, nxt);
    }
    cp_commit();
    compute(kt % STAGES);
  }
  cp_wait<0>();
  __syncthreads();
}

// The same with one load(buf, kt) for both operands and no gate.
template <int STAGES, typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int ktiles, Load load, Compute compute) {
  pipeline<STAGES>(ktiles, load, [] {}, [](int, int) {}, compute);
}

// Deterministic split-K fix-up without a second launch. Each of `splits`
// blocks of one output tile writes its fp32 accumulators (and `extra`
// further floats per thread, e.g. a bias-gradient partial) to
// part + s * per, in this thread's fragment order; the last block to
// arrive (counted on *counter) sums all splits in split order, into acc
// and ext, resets the counter to 0 and returns true. Every other block
// returns false. The order of the sum never depends on which block came
// last, so reruns are bitwise equal; no atomics touch the data.
template <int THREADS, int MI, int NI, int EXTRA>
__device__ __forceinline__ bool split_fixup(float (&acc)[MI][NI][4], float (&ext)[EXTRA + 1],
                                            float* part, int splits, int s, int* counter) {
  constexpr int PER = (MI * NI * 4 + EXTRA) * THREADS;
  __shared__ int last;
  float* mine = part + (size_t)s * PER + threadIdx.x;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[((i * NI + j) * 4 + e) * THREADS] = acc[i][j][e];
#pragma unroll
  for (int x = 0; x < EXTRA; ++x) mine[(MI * NI * 4 + x) * THREADS] = ext[x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  zero<MI, NI>(acc);
#pragma unroll
  for (int x = 0; x < EXTRA; ++x) ext[x] = 0.f;
  for (int q = 0; q < splits; ++q) {
    const float* src = part + (size_t)q * PER + threadIdx.x;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += __ldcg(src + ((i * NI + j) * 4 + e) * THREADS);
#pragma unroll
    for (int x = 0; x < EXTRA; ++x) ext[x] += __ldcg(src + (MI * NI * 4 + x) * THREADS);
  }
  if (threadIdx.x == 0) *counter = 0;
  return true;
}

__device__ __forceinline__ void store2(bf16* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

// Block tiles of a product: four warps, 64-deep k-tiles.
constexpr int THREADS = 128;
constexpr int BK = 64;

// A block's tile of a product, BM x BN with the 4 warps in WM x WN, and a
// ring of STAGES k-tiles.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Gemm {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, NSTAGE = STAGES_;
  static constexpr int MI = BM / WM / 16, NI = BN / WN / 8;
  static_assert(WM * WN * 32 == THREADS, "four warps");
  template <bool A_T>
  __host__ __device__ static constexpr int lda() { return A_T ? BM + 8 : BK + 8; }
  template <bool B_T>
  __host__ __device__ static constexpr int ldb() { return B_T ? BK + 8 : BN + 8; }
  template <bool A_T>
  __host__ __device__ static constexpr int a_el() { return (A_T ? BK : BM) * lda<A_T>(); }
  template <bool B_T>
  __host__ __device__ static constexpr int b_el() { return (B_T ? BN : BK) * ldb<B_T>(); }
  template <bool A_T, bool B_T>
  __host__ __device__ static constexpr size_t smem() {
    return 2 * (size_t)NSTAGE * (a_el<A_T>() + b_el<B_T>());
  }
};

// acc = A[m rows of the tile, k-tiles kt0..kt1) B[.., n cols of the
// tile]. srcA(r, c, k0) / srcB(r, c, k0) address element (r, c..c+7) of
// the tile as stored (A_T: [k][m], else [m][k]; B_T: [n][k], else
// [k][n]) for the k-tile at k0, or return nullptr for zeros. after(Bs,
// ldb) runs on each landed B tile. gate() runs once the first tiles of
// one operand (B, or A with A_FIRST) are in flight and before any copy of
// the other (pipeline).
template <class G, bool A_T, bool B_T, bool A_FIRST = false, class SrcA, class SrcB, class After,
          class Gate>
__device__ __forceinline__ void gemm_tile(float (&acc)[G::MI][G::NI][4], bf16* ring, int kt0,
                                          int kt1, SrcA srcA, SrcB srcB, After after, Gate gate) {
  constexpr int LA = G::template lda<A_T>(), LB = G::template ldb<B_T>();
  constexpr int AE = G::template a_el<A_T>(), SE = AE + G::template b_el<B_T>();
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / G::WN) * (G::BM / G::WM), n0 = (warp % G::WN) * (G::BN / G::WN);
  zero<G::MI, G::NI>(acc);
  auto load_b = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile<B_T ? G::BN : BK, B_T ? BK : G::BN, THREADS>(
        ring + buf * SE + AE, LB, B_T ? G::BN : BK, [&](int r, int c) { return srcB(r, c, k0); });
  };
  auto load_a = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    load_tile<A_T ? BK : G::BM, A_T ? G::BM : BK, THREADS>(
        ring + buf * SE, LA, A_T ? BK : G::BM, [&](int r, int c) { return srcA(r, c, k0); });
  };
  auto compute = [&](int buf) {
    const bf16* as = ring + buf * SE;
    warp_mma<G::MI, G::NI, A_T, B_T>(acc, as, LA, as + AE, LB, m0, n0, BK);
    after(as + AE, LB);
  };
  if (A_FIRST) pipeline<G::NSTAGE>(kt1 - kt0, load_a, gate, load_b, compute);
  else pipeline<G::NSTAGE>(kt1 - kt0, load_b, gate, load_a, compute);
}

// Calls f(row, col, v0, v1) for the accumulator pairs (row, col..col+1)
// of this thread, in the tile at (mb, nb).
template <class G, class F>
__device__ __forceinline__ void for_pairs(const float (&acc)[G::MI][G::NI][4], int mb, int nb,
                                          F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = mb + (warp / G::WN) * (G::BM / G::WM), n0 = nb + (warp % G::WN) * (G::BN / G::WN);
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int j = 0; j < G::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(m0 + 16 * i + g + 8 * h, n0 + 8 * j + 2 * t, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// Streaming multiprocessors of the current device (132 on the H100),
// read once; the launch plans fill the card by it.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      n = count;
  }
  return n > 0 ? n : 1;
}

// One launch of THREADS-thread blocks with one launch attribute: a
// cluster shape, or programmatic dependent launch (the kernel may start
// while the one before it on the stream finishes, and gates on
// griddep_wait).
template <typename Kernel, typename Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                          cudaLaunchAttribute attr, const Args& args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// Programmatic dependent launch after the previous kernel on the stream
// (overlap = true), or plain stream order (false).
inline cudaLaunchAttribute after_previous(bool overlap = true) {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = overlap ? 1 : 0;
  return a;
}

}  // namespace tc
}  // namespace ldm
