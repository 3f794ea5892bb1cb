// Tensor-core route of the SwinBlock FFN (bfloat16), shared by
// ffn_tc_fwd.cuh (the forward of ffn_block and block_core) and
// ffn_block_bwd.cu (backward): tile shapes,
// the route's shape rule, the split-K plan and the gate product
// h @ [wa | wb] with its epilogue's element order.
//
// Every product is mma.sync m16n8k16 (bf16 in, fp32 accumulators) on 64 x
// 64 block tiles of four warps, operands streamed through a ring of
// cp.async stages (mma_common.cuh). k is split over blocks only where the
// grid has fewer blocks than two per SM, and the splits meet in
// tc::split_fixup (fixed order, no second launch), so reruns are bitwise
// equal. The split counters live in a buffer the wrapper keeps zeroed;
// every call leaves them zero.
//
// The gate tile holds 64 rows by 64 hidden columns of both a = h @ wa and
// b = h @ wb as one 64 x 128 product: its B tile interleaves wa's and wb's
// columns in 8-column chunks (tile column 16 q + e is wa's column 8 q + e
// for e < 8, wb's column 8 q + e - 8 otherwise), so that each thread holds
// a and b of the same elements, and the h tile is read once for both.
//
// int8 weights (the quantized route, gemm_tile_q): the weight k-tiles
// stream through the ring as int8, 16 values a 16-byte copy (half the
// bytes of bf16), and each landed tile is converted into one bf16 tile
// (exact: |q| <= 127), in the layout above, that the fragments are read
// from; the column scales and biases act in the epilogues.
#pragma once

#include "ffn_common.cuh"
#include "mma_common.cuh"

namespace ldm {
namespace ftc {

using tc::BK;
using tc::Gemm;
using tc::THREADS;
using tc::bf16;

// Block tiles: a ring of 3 k-tiles where the blocks are compute-bound
// (the backward), 4 where they wait on device memory (the forward, whose
// gate takes 2 when each block runs at most 2 k-tiles: twice the blocks
// per SM).
template <int STAGES>
using GateTile = Gemm<64, 128, 2, 2, STAGES>;  // h @ [wa | wb], 64 hidden columns
using GateG = GateTile<3>;
using Tile = Gemm<64, 64, 2, 2, 3>;            // every other product
constexpr int HN = 64;                         // hidden columns of a gate tile
constexpr int TILE_F = Tile::MI * Tile::NI * 4 * THREADS;     // fp32 per split of a tile
constexpr int GATE_F = GateG::MI * GateG::NI * 4 * THREADS;   // ... of a gate tile

// split counters the wrapper keeps zeroed: a plan uses at most four times
// the SM count (only tiles with fewer blocks than two per SM split)
constexpr int kCounters = 4096;

// 16-byte chunks of a bf16 row (8 elements) each lane of
// norm_film_rows_kernel holds (of an fp32 row, twice as many)
constexpr int kNormChunks = 4;

// The shapes the route takes: C and M multiples of 64, C <= 1024 (every
// UNet width, 128-1024), any row count.
__host__ __device__ inline bool takes(int N, int C, int M) {
  return N >= 1 && C >= BK && M >= BK && C % BK == 0 && M % BK == 0 &&
         C <= 32 * 8 * kNormChunks;
}

// h = T(channel_norm(x) * mul + bias) as norm_film_kernel computes it, for
// the shapes takes() accepts (T bf16, or float for block_core's fp32
// route): one warp per row holds the row in registers (16-byte loads, one
// pass over x), so a row costs a few load latencies, not C / 32 dependent
// ones. A programmatic dependent launch after it may start at once. 256
// threads a block.
template <typename T>
__global__ void __launch_bounds__(256)
norm_film_rows_kernel(const T* __restrict__ x, const T* __restrict__ mul,
                      const T* __restrict__ bias, int rows, int C, int film_rows, float eps,
                      T* __restrict__ h) {
  // elements of a 16-byte chunk, and chunks a lane holds
  constexpr int E = 16 / sizeof(T), U = kNormChunks * 8 / E;
  tc::griddep_launch();
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int chunks = C / E;
  float v[U][E];
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = E * (lane + 32 * u);
    if (c >= C) continue;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)row * C + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < E; ++k) s += v[u][k] = to_f(e[k]);
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (lane + 32 * u >= chunks) continue;
#pragma unroll
    for (int k = 0; k < E; ++k) q += (v[u][k] - mean) * (v[u][k] - mean);
  }
  const float rs = rsqrtf(warp_sum(q) / (C - 1) + eps);
  const size_t fr = (size_t)(row % film_rows) * C;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = E * (lane + 32 * u);
    if (c >= C) continue;
    const uint4 mr = *reinterpret_cast<const uint4*>(mul + fr + c);
    const uint4 br = *reinterpret_cast<const uint4*>(bias + fr + c);
    const T *m = reinterpret_cast<const T*>(&mr), *b = reinterpret_cast<const T*>(&br);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < E; ++k) o[k] = from_f<T>((v[u][k] - mean) * rs * to_f(m[k]) + to_f(b[k]));
    *reinterpret_cast<uint4*>(h + (size_t)row * C + c) = out;
  }
}

// k-tiles split over blocks: until the grid has two blocks per SM, with
// at least 4 k-tiles each.
inline Split split_k(int tiles, int kt) {
  const int sms = tc::sm_count();
  int s = 1;
  if (tiles < 2 * sms) {
    s = (2 * sms + tiles - 1) / tiles;
    s = s < kt / 4 ? s : kt / 4;
    s = s > 1 ? s : 1;
  }
  const int per = (kt + s - 1) / s;
  return Split{(kt + per - 1) / per, per};
}

// acc = h[mb.., k-tiles kt0..kt1) @ [wa | wb][.., hidden nbh..nbh + 64),
// interleaved as above; wa, wb [C, M]. gate() as tc::gemm_tile's (the
// weights stream first, h after it).
template <class G, class Gate>
__device__ __forceinline__ void ab_tile(float (&acc)[G::MI][G::NI][4], bf16* ring,
                                        const bf16* h, int N, int C, int M, const bf16* wa,
                                        const bf16* wb, int mb, int nbh, int kt0, int kt1,
                                        Gate gate) {
  tc::gemm_tile<G, false, false>(
      acc, ring, kt0, kt1,
      [&](int r, int c, int k0) -> const bf16* {
        return mb + r < N ? h + (size_t)(mb + r) * C + k0 + c : nullptr;
      },
      [&](int r, int c, int k0) -> const bf16* {
        return ((c & 8) ? wb : wa) + (size_t)(k0 + r) * M + nbh + (c >> 4) * 8;
      },
      [](const bf16*, int) {}, gate);
}

// 16 int8 (one 16-byte chunk) as 16 bf16: elements 0-7 in lo, 8-15 in
// hi. Each byte, made unsigned (q + 128), goes into the mantissa of 2**23
// and the float subtraction of 2**23 + 128 leaves q exactly: no
// integer-to-float conversion instruction.
__device__ __forceinline__ void i8x16_to_bf16(const uint4& raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t u = w[k / 2], sel = 0x7540u + 2 * (k % 2);
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) - 8388736.f;
    o[k] = tc::pack_bf16(f0, f1);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// Shared memory of gemm_tile_q for block tile G: a ring of NSTAGE stages,
// each a bf16 A k-tile and an int8 B k-tile (rows of BN bytes, padded by
// 16), then the one bf16 B tile the fragments are read from.
template <class G>
struct QTile {
  static constexpr int LA = G::template lda<false>();  // A row, elements
  static constexpr int LQ = G::BN + 16;                // int8 B row, bytes
  static constexpr int LB = G::template ldb<false>();  // bf16 B row, elements
  static constexpr int A_BYTES = 2 * G::BM * LA;
  static constexpr int STAGE = A_BYTES + BK * LQ;
  static constexpr size_t smem = (size_t)G::NSTAGE * STAGE + 2 * (size_t)BK * LB;
  static_assert(A_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte chunks");
};

// gemm_tile's product (A_T, B_T false) with int8 B: acc = A[tile rows,
// k-tiles kt0..kt1) B[.., tile columns], B's elements converted exactly
// to bf16. srcA(r, c, k0) as gemm_tile's; srcQ(r, c, k0) addresses the
// 16 int8 of B's stored tile row r, columns c..c+15 (c a multiple of 16);
// place(c) gives the bf16 tile columns of that chunk's two halves (so a
// tile may interleave two matrices). after(kt) runs once the k-tile kt's
// product is in acc; gate() as gemm_tile's (B streams first).
template <class G, class SrcA, class SrcQ, class Place, class After, class Gate>
__device__ __forceinline__ void gemm_tile_q(float (&acc)[G::MI][G::NI][4], unsigned char* smem,
                                            int kt0, int kt1, SrcA srcA, SrcQ srcQ, Place place,
                                            After after, Gate gate) {
  using L = QTile<G>;
  constexpr int CH = G::BN / 16;  // 16-byte chunks of an int8 row
  static_assert(BK * CH % THREADS == 0, "whole passes of the conversion");
  bf16* bs = reinterpret_cast<bf16*>(smem + G::NSTAGE * L::STAGE);
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp / G::WN) * (G::BM / G::WM), n0 = (warp % G::WN) * (G::BN / G::WN);
  tc::zero<G::MI, G::NI>(acc);
  auto a_tile = [&](int buf) { return reinterpret_cast<bf16*>(smem + buf * L::STAGE); };
  auto q_tile = [&](int buf) { return smem + buf * L::STAGE + L::A_BYTES; };
  auto load_q = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    tc::load_tile_i8<BK, G::BN, THREADS>(q_tile(buf), L::LQ, BK,
                                         [&](int r, int c) { return srcQ(r, c, k0); });
  };
  auto load_a = [&](int buf, int i) {
    const int k0 = (kt0 + i) * BK;
    tc::load_tile<G::BM, BK, THREADS>(a_tile(buf), L::LA, G::BM,
                                  [&](int r, int c) { return srcA(r, c, k0); });
  };
  int kt = kt0;
  auto compute = [&](int buf) {
    const unsigned char* q = q_tile(buf);
#pragma unroll
    for (int u = 0; u < BK * CH / THREADS; ++u) {
      const int idx = threadIdx.x + u * THREADS, r = idx / CH, c = (idx % CH) * 16;
      uint4 lo, hi;
      i8x16_to_bf16(*reinterpret_cast<const uint4*>(q + r * L::LQ + c), lo, hi);
      const int2 dst = place(c);
      *reinterpret_cast<uint4*>(bs + r * L::LB + dst.x) = lo;
      *reinterpret_cast<uint4*>(bs + r * L::LB + dst.y) = hi;
    }
    __syncthreads();  // the bf16 tile is whole; the next k-step's barrier frees it
    tc::warp_mma<G::MI, G::NI, false, false>(acc, a_tile(buf), L::LA, bs, L::LB, m0, n0, BK);
    after(kt++);
  };
  tc::pipeline<G::NSTAGE>(kt1 - kt0, load_q, gate, load_a, compute);
}

// Loads the biases of a tile's 64 columns before its k-loop (they are
// inputs: nothing waits for them), one per thread (v0 for threads 0-63,
// v1 for 64-127), and after it, with every thread, makes them readable as
// at(0 or 1, column - tile column 0) from shared memory.
struct TileBias {
  float* s;  // [2][HN] shared
  float r;
  __device__ __forceinline__ void share() {
    s[threadIdx.x] = r;
    __syncthreads();
  }
  __device__ __forceinline__ float at(int which, int c) const { return s[which * HN + c]; }
};
static_assert(THREADS == 2 * HN, "one bias per thread");

// Calls f(i, q, h, row, col) for this thread's element pairs (row,
// col..col+1) of the gate tile at (mb, nbh): a is acc[i][2 q][2 h..],
// b acc[i][2 q + 1][2 h..], and a Tile product's acc[i][q][2 h..] holds
// the same elements.
template <class F>
__device__ __forceinline__ void for_gate_pairs(int mb, int nbh, F f) {
  static_assert(GateG::MI == Tile::MI && GateG::NI == 2 * Tile::NI, "gate and Tile layouts");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = mb + (warp / GateG::WN) * (GateG::BM / GateG::WM);
  const int c0 = nbh + (warp % GateG::WN) * (HN / GateG::WN) + 2 * t;
#pragma unroll
  for (int i = 0; i < GateG::MI; ++i)
#pragma unroll
    for (int q = 0; q < Tile::NI; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) f(i, q, h, m0 + 16 * i + g + 8 * h, c0 + 8 * q);
}

}  // namespace ftc
}  // namespace ldm

// The route of an ffn_block forward call: float32 and bfloat16 at widths
// the tensor-core kernels take (every UNet shape; fp32 as TF32 passes,
// ffn_tf32_fwd.cuh) run on them, any other width on the FMA chain
// (block_core has block_core_tensor_cores, the same rule; the backward
// its own, ffn_bwd_tensor_cores). It depends on the dtype and the shape
// alone.
extern "C" int ffn_tensor_cores(int dtype, int N, int C, int M) {
  return (dtype == 0 || dtype == 1) && ldm::ftc::takes(N, C, M);
}

// int32 split counters the tensor-core route needs zeroed before its
// first call; every call leaves them zero.
extern "C" long long ffn_counter_ints() { return ldm::ftc::kCounters; }
