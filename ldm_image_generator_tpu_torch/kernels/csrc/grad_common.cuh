// Products shared by the backward kernels (ffn_block_bwd.cu and the
// backward of window_attention.cu), on the tiled fp32 FMA loop of
// common.cuh:
//
//   atb: weight gradients, out_z = A_z^T @ B_z over the rows (k = the N
//        activation rows). A_z is an activation [K, R], B_z a cotangent
//        [K, ncol]; with `ones` a last row R holds the column sums of B_z
//        (the bias gradient). Rows are split over blocks; each block writes
//        its fp32 partial and a second pass adds them in a fixed order, so
//        a rerun is bitwise equal (no atomics).
//   abt: input gradients, out = T(sum_s A_s @ B_s^T), A_s [N, K] and B_s a
//        weight [ncol, K] read transposed in place; the segments' products
//        share one fp32 accumulator and are rounded once.
#pragma once

#include "common.cuh"

namespace ldm {

constexpr int kMaxMats = 9;
constexpr int kMaxSegs = 6;

// A weight operand, or the slice of a stacked [E, ...] expert tensor that
// the device-resident id ids[which] selects (which >= 0).
struct WeightRef {
  const void* base;
  int which;
  size_t stride;
};

template <typename T>
__device__ __forceinline__ const T* resolve(const WeightRef& w, const int* ids, int E) {
  if (w.which < 0) return (const T*)w.base;
  const int e = ids[w.which];
  if (e < 0 || e >= E) __trap();  // out-of-range routing is a caller bug
  return (const T*)w.base + (size_t)e * w.stride;
}

struct AtbArgs {
  int nmat;
  const void* A[kMaxMats];
  int lda[kMaxMats];
  const void* B[kMaxMats];
  int ldb[kMaxMats];
  float* out[kMaxMats];  // [R + ones, ncol] fp32 each
  int K, R, ncol, ones;
  float* part;  // [nmat * splits, R + ones, ncol] when split
};

using TileW = TileL;  // weight gradients: few outputs, long k

inline Split atb_split(int nmat, int R, int ncol, int K) {
  const int tiles = ((R + 1 + TileW::BM - 1) / TileW::BM) * ((ncol + TileW::BN - 1) / TileW::BN);
  return choose_split(nmat * tiles, (K + BK - 1) / BK);
}

inline size_t atb_part_floats(int nmat, int R, int ncol, int K, int ones) {
  const Split s = atb_split(nmat, R, ncol, K);
  return s.splits > 1 ? (size_t)nmat * s.splits * (R + ones) * ncol : 0;
}

// grid (ceil(ncol / BN), ceil((R + ones) / BM), nmat * split.splits).
template <typename T>
__global__ void __launch_bounds__(TileW::THREADS) atb_kernel(AtbArgs a, Split split) {
  using S = TileW;
  const int z = blockIdx.z / split.splits, s = blockIdx.z % split.splits;
  const int rows = a.R + a.ones;
  __shared__ TileSmem<S, 1> sm;
  float acc[1][S::TM][S::TN];
  zero_acc<S, 1>(acc);
  const T* B[1] = {(const T*)a.B[z]};
  const int k_end = min(a.K, (s + 1) * split.per * BK);
  tile_product<S, 1, true, false>((const T*)a.A[z], a.lda[z], a.R, a.K, blockIdx.y * S::BM, B,
                                  a.ldb[z], a.ncol, blockIdx.x * S::BN, s * split.per * BK,
                                  k_end, sm, acc, a.ones ? a.R : -1);
  float* o = split.splits > 1 ? a.part + (size_t)blockIdx.z * rows * a.ncol : a.out[z];
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = acc_row<S>(i);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int col = acc_col<S>(j);
      if (col < a.ncol) o[(size_t)row * a.ncol + col] = acc[0][i][j];
    }
  }
}

// out_z = the sum of its split partials, in split order.
__global__ void atb_finish_kernel(AtbArgs a, int splits) {
  const size_t per = (size_t)(a.R + a.ones) * a.ncol;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)a.nmat * per) return;
  const int z = idx / per;
  const size_t o = idx % per;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += a.part[(size_t)(z * splits + s) * per + o];
  a.out[z][o] = v;
}

template <typename T>
void atb(const AtbArgs& a, cudaStream_t st) {
  using S = TileW;
  const Split sp = atb_split(a.nmat, a.R, a.ncol, a.K);
  dim3 grid((a.ncol + S::BN - 1) / S::BN, (a.R + a.ones + S::BM - 1) / S::BM, a.nmat * sp.splits);
  atb_kernel<T><<<grid, S::THREADS, 0, st>>>(a, sp);
  if (sp.splits > 1) {
    const size_t n = (size_t)a.nmat * (a.R + a.ones) * a.ncol;
    atb_finish_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, sp.splits);
  }
}

struct AbtArgs {
  int nseg;
  const void* A[kMaxSegs];
  int lda[kMaxSegs];
  WeightRef B[kMaxSegs];  // [ncol, K] row-major each, read transposed
  int ldb;
  const int* ids;
  int E;
  int N, K, ncol;
  void* out;  // T [N, ncol]
  float* part;  // [splits, N, ncol] when split
};

struct AbtPlan {
  bool large;
  Split split;
  size_t floats;
};

inline AbtPlan abt_plan(int nseg, int N, int K, int ncol) {
  AbtPlan p;
  p.large = use_large_tile(N, ncol);
  const int bm = p.large ? TileL::BM : TileS::BM, bn = p.large ? TileL::BN : TileS::BN;
  p.split = choose_split(((ncol + bn - 1) / bn) * ((N + bm - 1) / bm), nseg * ((K + BK - 1) / BK));
  p.floats = p.split.splits > 1 ? (size_t)p.split.splits * N * ncol : 0;
  return p;
}

// k-tiles [s * per, (s + 1) * per) of the nseg * ceil(K / BK) tiles;
// grid (ceil(ncol / BN), ceil(N / BM), splits).
template <typename T, typename S>
__global__ void __launch_bounds__(S::THREADS) abt_kernel(AbtArgs a, Split split) {
  const int s = blockIdx.z;
  __shared__ TileSmem<S, 1> sm;
  float acc[1][S::TM][S::TN];
  zero_acc<S, 1>(acc);
  const int kt = (a.K + BK - 1) / BK;
  const int lo = s * split.per, hi = min(a.nseg * kt, (s + 1) * split.per);
  for (int g = 0; g < a.nseg; ++g) {
    const int t0 = max(lo, g * kt) - g * kt, t1 = min(hi, (g + 1) * kt) - g * kt;
    if (t0 >= t1) continue;
    const T* B[1] = {resolve<T>(a.B[g], a.ids, a.E)};
    tile_product<S, 1, false, true>((const T*)a.A[g], a.lda[g], a.N, a.K, blockIdx.y * S::BM, B,
                                    a.ldb, a.ncol, blockIdx.x * S::BN, t0 * BK, t1 * BK, sm,
                                    acc);
  }
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = acc_row<S>(i);
    if (row >= a.N) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int col = acc_col<S>(j);
      if (col >= a.ncol) continue;
      const size_t o = (size_t)row * a.ncol + col;
      if (split.splits > 1) a.part[(size_t)s * a.N * a.ncol + o] = acc[0][i][j];
      else ((T*)a.out)[o] = from_f<T>(acc[0][i][j]);
    }
  }
}

// out = T(sum of the split partials, in split order).
template <typename T>
__global__ void abt_finish_kernel(AbtArgs a, int splits) {
  const size_t n = (size_t)a.N * a.ncol;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += a.part[(size_t)s * n + idx];
  ((T*)a.out)[idx] = from_f<T>(v);
}

template <typename T, typename S>
void launch_abt(const AbtArgs& a, Split sp, cudaStream_t st) {
  dim3 grid((a.ncol + S::BN - 1) / S::BN, (a.N + S::BM - 1) / S::BM, sp.splits);
  abt_kernel<T, S><<<grid, S::THREADS, 0, st>>>(a, sp);
  if (sp.splits > 1) {
    const size_t n = (size_t)a.N * a.ncol;
    abt_finish_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, sp.splits);
  }
}

template <typename T>
void abt(const AbtArgs& a, cudaStream_t st) {
  const AbtPlan p = abt_plan(a.nseg, a.N, a.K, a.ncol);
  if (p.large) launch_abt<T, TileL>(a, p.split, st);
  else launch_abt<T, TileS>(a, p.split, st);
}

}  // namespace ldm
