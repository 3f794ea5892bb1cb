// Shared pieces of the port's Hopper kernels: dtype conversion and a
// shared-memory-tiled product with fp32 accumulation on the CUDA cores.
//
// Every kernel here is templated on the working type T (float or
// __nv_bfloat16). Operands are converted to fp32 as they enter shared
// memory, products accumulate in fp32 registers, and results are rounded
// to T (round to nearest even, as JAX's astype) at the points the
// Pallas kernels round.
//
// At batch 1 the products are skinny (16 to 1024 rows against C x C
// weights), so a block's k-loop is bound by device-memory latency, not
// by arithmetic. Two things hide it: the next k-tile is fetched into
// registers while the current one is multiplied, and the k dimension is
// split over blocks (split-K) until the card has a few blocks per SM;
// the fp32 partial sums then meet in a second, elementwise pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ldm {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
// an int8 weight (quantized FFN route): exact in fp32 and in bf16
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Depth of one k-step of the tiled product.
constexpr int BK = 16;
// Split-K aims for this many blocks in flight (4 per SM of the H100).
constexpr int kTargetBlocks = 4 * 132;

// Output tile of BM x BN per block; each thread owns TM x TN outputs at
// rows ty + i * RY and columns tx + j * CX (strided, so neighbouring
// threads read neighbouring shared-memory words).
template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int RY = BM / TM;
  static constexpr int CX = BN / TN;
  static constexpr int THREADS = RY * CX;
  // elements of the A and B k-tiles each thread fetches
  static constexpr int A_PER = (BM * BK + THREADS - 1) / THREADS;
  static constexpr int B_PER = (BK * BN + THREADS - 1) / THREADS;
};

// Many rows (large batch, C=128 stage at batch >= 4).
using TileL = Tile<64, 64, 4, 4>;
// Few rows (batch 1): narrow tiles so enough blocks stream the weights.
using TileS = Tile<16, 32, 1, 2>;

// Pick the tile for an output of rows x cols: the large tile only when
// it still gives at least one block per SM.
inline bool use_large_tile(int rows, int cols) {
  return ((rows + 63) / 64) * ((cols + 63) / 64) >= 132;
}

// How a k dimension of k_tiles tiles is split over blocks.
struct Split {
  int splits;  // blocks along k
  int per;     // k-tiles per split
};

inline Split choose_split(int base_blocks, int k_tiles) {
  // two blocks per SM already hide the latency; splitting further only
  // adds the partial sums' traffic
  if (base_blocks >= 2 * 132) return Split{1, k_tiles};
  int s = (kTargetBlocks + base_blocks - 1) / base_blocks;
  const int most = k_tiles / 4 > 1 ? k_tiles / 4 : 1;  // >= 4 k-tiles each
  s = s < most ? s : most;
  s = s > 1 ? s : 1;
  const int per = (k_tiles + s - 1) / s;
  return Split{(k_tiles + per - 1) / per, per};
}

// The k-tiles [k0, k0 + BK) of A rows row0.. and of B columns col0..,
// zero outside [rows) x [K) and [K) x [cols). A is [rows, K] row-major,
// or with AT stored transposed ([K, rows], element (r, k) at A[k * lda +
// r]); B is [K, cols] row-major, or with BT stored transposed ([cols, K]).
// Neighbouring threads take neighbouring addresses in either layout. With
// AT and ones_row >= rows, A's row ones_row reads 1 (a bias gradient's
// row sum). The row-major paths compile to the forward kernels' loads.
template <typename S, bool AT = false, typename T>
__device__ __forceinline__ void fetch_a(float (&ra)[S::A_PER], const T* __restrict__ A, int lda,
                                        int rows, int K, int row0, int k0, int ones_row = -1) {
#pragma unroll
  for (int u = 0; u < S::A_PER; ++u) {
    const int idx = threadIdx.x + u * S::THREADS;
    if constexpr (AT) {
      const int gr = row0 + idx % S::BM, gk = k0 + idx / S::BM;
      float v = 0.f;
      if (idx < S::BM * BK && gk < K) {
        if (gr < rows) v = to_f(A[(size_t)gk * lda + gr]);
        else if (gr == ones_row) v = 1.f;
      }
      ra[u] = v;
    } else {
      const int gr = row0 + idx / BK, gk = k0 + idx % BK;
      ra[u] = (idx < S::BM * BK && gr < rows && gk < K) ? to_f(A[(size_t)gr * lda + gk]) : 0.f;
    }
  }
}

template <typename S, bool BT = false, typename T>
__device__ __forceinline__ void fetch_b(float (&rb)[S::B_PER], const T* __restrict__ B, int ldb,
                                        int K, int cols, int k0, int col0) {
#pragma unroll
  for (int u = 0; u < S::B_PER; ++u) {
    const int idx = threadIdx.x + u * S::THREADS;
    if constexpr (BT) {
      const int gk = k0 + idx % BK, gc = col0 + idx / BK;
      rb[u] = (idx < BK * S::BN && gk < K && gc < cols) ? to_f(B[(size_t)gc * ldb + gk]) : 0.f;
    } else {
      const int gk = k0 + idx / S::BN, gc = col0 + idx % S::BN;
      rb[u] = (idx < BK * S::BN && gk < K && gc < cols) ? to_f(B[(size_t)gk * ldb + gc]) : 0.f;
    }
  }
}

template <typename S, bool AT = false>
__device__ __forceinline__ void store_a(float (*As)[S::BM + 1], const float (&ra)[S::A_PER]) {
#pragma unroll
  for (int u = 0; u < S::A_PER; ++u) {
    const int idx = threadIdx.x + u * S::THREADS;
    if (idx < S::BM * BK) {
      if constexpr (AT) As[idx / S::BM][idx % S::BM] = ra[u];
      else As[idx % BK][idx / BK] = ra[u];
    }
  }
}

template <typename S, bool BT = false>
__device__ __forceinline__ void store_b(float (*Bs)[S::BN], const float (&rb)[S::B_PER]) {
#pragma unroll
  for (int u = 0; u < S::B_PER; ++u) {
    const int idx = threadIdx.x + u * S::THREADS;
    if (idx < BK * S::BN) {
      if constexpr (BT) Bs[idx % BK][idx / BK] = rb[u];
      else Bs[idx / S::BN][idx % S::BN] = rb[u];
    }
  }
}

// acc += As^T[k] (x) Bs[k] over one k-step.
template <typename S>
__device__ __forceinline__ void fma_tile(float (*As)[S::BM + 1], float (*Bs)[S::BN],
                                         float (&acc)[S::TM][S::TN]) {
  const int ty = threadIdx.x / S::CX, tx = threadIdx.x % S::CX;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[S::TM], b[S::TN];
#pragma unroll
    for (int i = 0; i < S::TM; ++i) a[i] = As[k][ty + i * S::RY];
#pragma unroll
    for (int j = 0; j < S::TN; ++j) b[j] = Bs[k][tx + j * S::CX];
#pragma unroll
    for (int i = 0; i < S::TM; ++i)
#pragma unroll
      for (int j = 0; j < S::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Shared memory of one block's product: the A tile and NB B tiles.
template <typename S, int NB>
struct TileSmem {
  float a[BK][S::BM + 1];
  float b[NB][BK][S::BN];
};

// acc[nb] += A[row0.., k_begin:k_end] @ B[nb][k_begin:k_end, col0..] for
// NB right-hand sides sharing A, with the next k-tile fetched into
// registers while the current one is multiplied. k_begin is a multiple
// of BK; loads past K read zero. AT, BT and ones_row as fetch_a/fetch_b.
// B may have another element type than A (int8 weights).
template <typename S, int NB, bool AT = false, bool BT = false, typename T, typename TB>
__device__ __forceinline__ void tile_product(const T* __restrict__ A, int lda, int rows, int K,
                                             int row0, const TB* const (&B)[NB], int ldb,
                                             int cols, int col0, int k_begin, int k_end,
                                             TileSmem<S, NB>& sm,
                                             float (&acc)[NB][S::TM][S::TN], int ones_row = -1) {
  if (k_begin >= k_end) return;
  float ra[S::A_PER];
  float rb[NB][S::B_PER];
  fetch_a<S, AT>(ra, A, lda, rows, K, row0, k_begin, ones_row);
#pragma unroll
  for (int n = 0; n < NB; ++n) fetch_b<S, BT>(rb[n], B[n], ldb, K, cols, k_begin, col0);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    store_a<S, AT>(sm.a, ra);
#pragma unroll
    for (int n = 0; n < NB; ++n) store_b<S, BT>(sm.b[n], rb[n]);
    __syncthreads();
    if (k0 + BK < k_end) {
      fetch_a<S, AT>(ra, A, lda, rows, K, row0, k0 + BK, ones_row);
#pragma unroll
      for (int n = 0; n < NB; ++n) fetch_b<S, BT>(rb[n], B[n], ldb, K, cols, k0 + BK, col0);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) fma_tile<S>(sm.a, sm.b[n], acc[n]);
    __syncthreads();
  }
}

template <typename S, int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][S::TM][S::TN]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < S::TM; ++i)
#pragma unroll
      for (int j = 0; j < S::TN; ++j) acc[n][i][j] = 0.f;
}

// Row and column of accumulator element (i, j) of this thread.
template <typename S>
__device__ __forceinline__ int acc_row(int i) {
  return blockIdx.y * S::BM + threadIdx.x / S::CX + i * S::RY;
}
template <typename S>
__device__ __forceinline__ int acc_col(int j) {
  return blockIdx.x * S::BN + threadIdx.x % S::CX + j * S::CX;
}

// Let a kernel use more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace ldm

// Every library exports this so the Python side can name a failure.
extern "C" const char* ldm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
