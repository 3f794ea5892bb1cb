// Nearest-codebook search of the VectorQuantizer: for each of N vectors
// x[N, D] (D = 8, float32 or bfloat16, read as float32) the int32 argmin
// over the K rows of the float32 codebook e[K, D] of
//   score = ||e_k||^2 - 2 x . e_k
// with the first index on ties. The Hopper counterpart of
// nearest_codebook_indices_pallas (ldm_image_generator_tpu/kernels/vq.py),
// which kept the whole codebook and a [512, K] score tile in VMEM.
//
// Bound: N * K * (2D + 2) fp32 operations on a few hundred KB of inputs,
// so the CUDA cores' fp32 rate. An SM's 227 KB cannot hold the codebook
// (256 KB at K = 8192) and nothing carries over between blocks, so:
//   pass 1 (vq_partial): a block owns ROWS rows (ROWS_PER_THREAD per
//     thread, held in registers) and one slice of K; it streams the slice
//     through shared memory in chunks of CHUNK codes (computing ||e||^2 as
//     it loads them) and keeps a running (min score, index) per row with a
//     strict <, so the lowest index of the slice wins; every thread reads
//     the same code at a time, a shared-memory broadcast. Splitting K over
//     blocks gives the card a few blocks per SM at N = 4608.
//   pass 2 (vq_merge): one thread per row takes the slices' partials in
//     slice order with the same strict <, so a tie across slices also goes
//     to the first index. No atomics: reruns are bitwise equal.
// The dot is summed in fp32 (an FMA chain over d) and the score formed as
// e_sq - 2 * dot with one rounding, as the TPU kernel forms it.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int D = 8;
constexpr int THREADS = 128;
constexpr int ROWS_PER_THREAD = 4;
constexpr int ROWS = THREADS * ROWS_PER_THREAD;
constexpr int CHUNK = 256;
// pass 1 aims for this many blocks (4 per SM of the H100)...
constexpr int TARGET_BLOCKS = 4 * 132;
// ...but gives each slice at least this many codes
constexpr int MIN_SLICE = 64;
constexpr int MERGE_THREADS = 256;

// codes per slice for `splits` slices over k
inline int slice_len(int k, int splits) { return (k + splits - 1) / splits; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    vq_partial(const T* __restrict__ x, const float* __restrict__ e, int n, int k,
               int per_slice, float* __restrict__ part_min, int* __restrict__ part_idx) {
  __shared__ float4 e_s[CHUNK][2];
  __shared__ float esq_s[CHUNK];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS + tid;
  const int k_begin = blockIdx.y * per_slice;
  const int k_end = min(k, k_begin + per_slice);

  float xr[ROWS_PER_THREAD][D];
  float best[ROWS_PER_THREAD];
  int best_idx[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int row = row0 + i * THREADS;
#pragma unroll
    for (int d = 0; d < D; ++d)
      xr[i][d] = row < n ? ldm::to_f(x[(size_t)row * D + d]) : 0.0f;
    best[i] = CUDART_INF_F;
    best_idx[i] = k_begin;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += CHUNK) {
    const int cn = min(CHUNK, k_end - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = tid; j < cn; j += THREADS) {
      const float4* src = reinterpret_cast<const float4*>(e + (size_t)(c0 + j) * D);
      const float4 a = src[0], b = src[1];
      e_s[j][0] = a;
      e_s[j][1] = b;
      // products rounded, then summed in order (no contraction)
      float s = __fmul_rn(a.x, a.x);
      s = __fadd_rn(s, __fmul_rn(a.y, a.y));
      s = __fadd_rn(s, __fmul_rn(a.z, a.z));
      s = __fadd_rn(s, __fmul_rn(a.w, a.w));
      s = __fadd_rn(s, __fmul_rn(b.x, b.x));
      s = __fadd_rn(s, __fmul_rn(b.y, b.y));
      s = __fadd_rn(s, __fmul_rn(b.z, b.z));
      s = __fadd_rn(s, __fmul_rn(b.w, b.w));
      esq_s[j] = s;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < cn; ++j) {
      const float4 a = e_s[j][0], b = e_s[j][1];
      const float q = esq_s[j];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) {
        float dot = xr[i][0] * a.x;
        dot = fmaf(xr[i][1], a.y, dot);
        dot = fmaf(xr[i][2], a.z, dot);
        dot = fmaf(xr[i][3], a.w, dot);
        dot = fmaf(xr[i][4], b.x, dot);
        dot = fmaf(xr[i][5], b.y, dot);
        dot = fmaf(xr[i][6], b.z, dot);
        dot = fmaf(xr[i][7], b.w, dot);
        const float s = fmaf(-2.0f, dot, q);  // 2 * dot is exact: one rounding
        if (s < best[i]) {
          best[i] = s;
          best_idx[i] = c0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int row = row0 + i * THREADS;
    if (row < n) {
      part_min[(size_t)blockIdx.y * n + row] = best[i];
      part_idx[(size_t)blockIdx.y * n + row] = best_idx[i];
    }
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
    vq_merge(const float* __restrict__ part_min, const int* __restrict__ part_idx, int n,
             int splits, int* __restrict__ out) {
  const int row = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (row >= n) return;
  float best = CUDART_INF_F;
  int idx = part_idx[row];
  for (int s = 0; s < splits; ++s) {
    const float m = part_min[(size_t)s * n + row];
    if (m < best) {
      best = m;
      idx = part_idx[(size_t)s * n + row];
    }
  }
  out[row] = idx;
}

}  // namespace

// Slices of K for n rows: enough for TARGET_BLOCKS blocks in pass 1,
// each at least MIN_SLICE codes, none empty. The caller sizes the
// partials [splits, n] with it and passes it to vq_nearest.
extern "C" int vq_splits(int n, int k) {
  const int row_blocks = (n + ROWS - 1) / ROWS;
  int splits = (TARGET_BLOCKS + row_blocks - 1) / row_blocks;
  const int most = (k + MIN_SLICE - 1) / MIN_SLICE;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  const int per = slice_len(k, splits);
  return (k + per - 1) / per;
}

// out[n] = argmin_k (||e_k||^2 - 2 x_n . e_k), first index on ties.
// dtype of x: 0 = float32, 1 = bfloat16; e is float32 [k, 8]; part_min
// and part_idx hold splits * n values each (splits from vq_splits).
extern "C" int vq_nearest(int dtype, const void* x, const void* e, int n, int k, int splits,
                          void* out, void* part_min, void* part_idx, void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_slice = slice_len(k, splits);
  const dim3 grid((n + ROWS - 1) / ROWS, splits);
  float* pm = static_cast<float*>(part_min);
  int* pi = static_cast<int*>(part_idx);
  const float* ef = static_cast<const float*>(e);
  if (dtype == 0)
    vq_partial<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), ef, n, k,
                                                per_slice, pm, pi);
  else if (dtype == 1)
    vq_partial<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), ef, n, k, per_slice, pm, pi);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vq_merge<<<(n + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0, st>>>(
      pm, pi, n, splits, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
