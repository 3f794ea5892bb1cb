// The SwinBlock FFN as a chain of kernels, shared by ffn_block.cu and
// block_core.cu:
//
//   1. norm_film_kernel: h = T(channel_norm(x) * film_mul + film_bias),
//      statistics and the FiLM product in fp32 (unbiased variance,
//      rsqrt(var + eps)); film rows repeat with period film_rows, so a
//      batch-1 FiLM schedule serves any image batch without a copy.
//   2. gate_kernel: for r in {general, expert e1, expert e2}
//      g_r = T((h @ wa_r + ba_r) * relu(h @ wb_r + bb_r)), a and b in
//      fp32; the expert ids are read from device memory, and only the two
//      selected experts' weight slices are read. When k is split over
//      blocks, the fp32 partial a and b meet in gate_finish_kernel.
//   3. out_partial_kernel: fp32 partial sums of sum_r g_r @ wc_r, one
//      slice of the 3M-long k dimension per block row of the grid.
//   4. finish_kernel: out = T(sum of the partials + gbc + bc_e1 + bc_e2
//      [+ conv3x3_grouped(h) + conv_bias] [+ x]), rounded once. The
//      grouped conv (group width 32) runs here from shared memory: one
//      block holds an image row's 3 x (W + 2) x 32 h window and the
//      group's 9 x 32 x 32 taps.
//
// g and the partial sums live in scratch the Python wrapper allocates
// (ffn_scratch_floats says how much).
#pragma once

#include "common.cuh"

namespace ldm {

constexpr int kGroup = 32;  // grouped-conv group width the kernel takes

template <typename T>
__global__ void norm_film_kernel(const T* __restrict__ x, const T* __restrict__ mul,
                                 const T* __restrict__ bias, int rows, int C, int film_rows,
                                 float eps, T* __restrict__ h) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mean;
    q += d * d;
  }
  const float rs = rsqrtf(warp_sum(q) / (C - 1) + eps);
  const size_t fr = (size_t)(row % film_rows) * C;
  T* hr = h + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    const float hn = (to_f(xr[c]) - mean) * rs;
    hr[c] = from_f<T>(hn * to_f(mul[fr + c]) + to_f(bias[fr + c]));
  }
}

// Weight slice of expert ids[which] in a stacked [E, rows, cols] tensor.
template <typename T>
__device__ __forceinline__ const T* expert_slice(const T* w, const int* ids, int which, int E,
                                                 size_t stride) {
  const int e = ids[which];
  if (e < 0 || e >= E) __trap();  // out-of-range routing is a caller bug
  return w + (size_t)e * stride;
}

struct FfnArgs {
  const void *x, *mul, *bias;
  int film_rows;
  const void *gwa, *gba, *gwb, *gbb, *gwc, *gbc;
  const void *wa, *ba, *wb, *bb, *wc, *bc;
  int E;
  const int* ids;
  int N, C, M;
  void *out, *h, *g;
  float* scratch;  // fp32 partial sums
};

// Weights and biases of ReGLU r (0 general, 1 and 2 the routed experts).
template <typename T>
struct Reglu {
  const T *wa, *ba, *wb, *bb;
};

template <typename T>
__device__ __forceinline__ Reglu<T> reglu_in(const FfnArgs& a, int r) {
  if (r == 0) return {(const T*)a.gwa, (const T*)a.gba, (const T*)a.gwb, (const T*)a.gbb};
  const size_t cm = (size_t)a.C * a.M;
  return {expert_slice((const T*)a.wa, a.ids, r - 1, a.E, cm),
          expert_slice((const T*)a.ba, a.ids, r - 1, a.E, (size_t)a.M),
          expert_slice((const T*)a.wb, a.ids, r - 1, a.E, cm),
          expert_slice((const T*)a.bb, a.ids, r - 1, a.E, (size_t)a.M)};
}

// grid (ceil(M / BN), ceil(N / BM), 3 * split.splits).
template <typename T, typename S, bool SPLIT>
__global__ void __launch_bounds__(S::THREADS)
gate_kernel(FfnArgs a, Split split) {
  const int r = blockIdx.z / split.splits, s = blockIdx.z % split.splits;
  const Reglu<T> w = reglu_in<T>(a, r);
  __shared__ TileSmem<S, 2> sm;
  float acc[2][S::TM][S::TN];
  zero_acc<S, 2>(acc);
  const T* B[2] = {w.wa, w.wb};
  const int k_end = min(a.C, (s + 1) * split.per * BK);
  tile_product<S, 2>((const T*)a.h, a.C, a.N, a.C, blockIdx.y * S::BM, B, a.M, a.M,
                     blockIdx.x * S::BN, s * split.per * BK, k_end, sm, acc);
  const size_t nm = (size_t)a.N * a.M;
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = acc_row<S>(i);
    if (row >= a.N) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int col = acc_col<S>(j);
      if (col >= a.M) continue;
      const size_t o = (size_t)row * a.M + col;
      if (SPLIT) {
        float* p = a.scratch + (size_t)(r * split.splits + s) * 2 * nm;
        p[o] = acc[0][i][j];
        p[nm + o] = acc[1][i][j];
      } else {
        const float av = acc[0][i][j] + to_f(w.ba[col]);
        const float bv = acc[1][i][j] + to_f(w.bb[col]);
        ((T*)a.g)[(size_t)r * nm + o] = from_f<T>(av * fmaxf(bv, 0.f));
      }
    }
  }
}

// g from the split partial sums of a and b; one thread per element.
template <typename T>
__global__ void gate_finish_kernel(FfnArgs a, int splits) {
  const size_t nm = (size_t)a.N * a.M;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * nm) return;
  const int r = idx / nm;
  const size_t o = idx % nm;
  const int col = o % a.M;
  const Reglu<T> w = reglu_in<T>(a, r);
  float av = 0.f, bv = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = a.scratch + (size_t)(r * splits + s) * 2 * nm;
    av += p[o];
    bv += p[nm + o];
  }
  av += to_f(w.ba[col]);
  bv += to_f(w.bb[col]);
  ((T*)a.g)[idx] = from_f<T>(av * fmaxf(bv, 0.f));
}

// fp32 partials of sum_r g_r @ wc_r over k-tiles [s * per, (s + 1) * per)
// of the 3 * ceil(M / BK) tiles; grid (ceil(C / BN), ceil(N / BM), splits).
template <typename T, typename S>
__global__ void __launch_bounds__(S::THREADS)
out_partial_kernel(FfnArgs a, Split split, float* __restrict__ part) {
  const int s = blockIdx.z;
  const size_t mc = (size_t)a.M * a.C;
  const T* Wc[3] = {(const T*)a.gwc, expert_slice((const T*)a.wc, a.ids, 0, a.E, mc),
                    expert_slice((const T*)a.wc, a.ids, 1, a.E, mc)};
  __shared__ TileSmem<S, 1> sm;
  float acc[1][S::TM][S::TN];
  zero_acc<S, 1>(acc);
  const int mt = (a.M + BK - 1) / BK;
  const int lo = s * split.per, hi = min(3 * mt, (s + 1) * split.per);
  for (int r = 0; r < 3; ++r) {
    const int t0 = max(lo, r * mt) - r * mt, t1 = min(hi, (r + 1) * mt) - r * mt;
    if (t0 >= t1) continue;
    const T* B[1] = {Wc[r]};
    tile_product<S, 1>((const T*)a.g + (size_t)r * a.N * a.M, a.M, a.N, a.M,
                       blockIdx.y * S::BM, B, a.C, a.C, blockIdx.x * S::BN, t0 * BK,
                       t1 * BK, sm, acc);
  }
  float* p = part + (size_t)s * a.N * a.C;
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = acc_row<S>(i);
    if (row >= a.N) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int col = acc_col<S>(j);
      if (col < a.C) p[(size_t)row * a.C + col] = acc[0][i][j];
    }
  }
}

struct ConvArgs {
  const void* kernel;  // [3, 3, 32, C]; null: no conv branch
  const void* bias;    // [C]
  int H, W;
};

inline size_t conv_smem_bytes(int W) {
  return sizeof(float) * ((size_t)3 * (W + 2) * kGroup + 9 * kGroup * kGroup);
}

// out = T(sum_s part[s] + gbc + bc_e1 + bc_e2 [+ conv(h) + conv_bias]
// [+ residual]); blockDim (32, 8), blockIdx.x the 32-channel group.
// CONV: blockIdx.y = b * H + y, one image row per block, dynamic shared
// memory conv_smem_bytes(W). Otherwise blockIdx.y covers 32 rows.
template <typename T, bool CONV>
__global__ void __launch_bounds__(256)
finish_kernel(FfnArgs a, ConvArgs conv, const float* __restrict__ part, int splits,
              const T* __restrict__ residual) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kGroup + tx;
  const int C = a.C;
  const T* bc = (const T*)a.bc;
  const T* bc1 = expert_slice(bc, a.ids, 0, a.E, (size_t)C);
  const T* bc2 = expert_slice(bc, a.ids, 1, a.E, (size_t)C);
  int n0, n_step, n_count;
  float* hs = smem;                           // [3][W + 2][32]
  float* ks = smem + 3 * (conv.W + 2) * kGroup;  // [9][32][32]
  if (CONV) {
    const int W = conv.W, y = blockIdx.y % conv.H;
    const int cin0 = blockIdx.x * kGroup;
    const T* h = (const T*)a.h;
    const T* k = (const T*)conv.kernel;
    for (int idx = ty * 32 + tx; idx < 3 * (W + 2) * kGroup; idx += 256) {
      const int i = idx % kGroup, xx = (idx / kGroup) % (W + 2), ky = idx / (kGroup * (W + 2));
      const int yy = y + ky - 1, xs = xx - 1;
      float v = 0.f;
      if (yy >= 0 && yy < conv.H && xs >= 0 && xs < W)
        v = to_f(h[((size_t)(blockIdx.y - y + yy) * W + xs) * C + cin0 + i]);
      hs[idx] = v;
    }
    for (int idx = ty * 32 + tx; idx < 9 * kGroup * kGroup; idx += 256) {
      const int co = idx % kGroup, ti = idx / kGroup;  // ti = tap * 32 + i
      ks[idx] = to_f(k[(size_t)ti * C + cin0 + co]);
    }
    __syncthreads();
    n0 = blockIdx.y * W;
    n_step = 8;
    n_count = W;
  } else {
    n0 = blockIdx.y * 32;
    n_step = 8;
    n_count = min(32, a.N - n0);
  }
  if (c >= C) return;
  const float bias = to_f(((const T*)a.gbc)[c]) + to_f(bc1[c]) + to_f(bc2[c]) +
                     (CONV ? to_f(((const T*)conv.bias)[c]) : 0.f);
  for (int xi = ty; xi < n_count; xi += n_step) {
    const size_t n = (size_t)(n0 + xi);
    float v = bias;
    for (int s = 0; s < splits; ++s) v += part[((size_t)s * a.N + n) * C + c];
    if (CONV) {
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* hp = hs + (ky * (conv.W + 2) + xi + kx) * kGroup;
          const float* kp = ks + (ky * 3 + kx) * kGroup * kGroup + tx;
#pragma unroll 8
          for (int i = 0; i < kGroup; ++i) acc = fmaf(hp[i], kp[i * kGroup], acc);
        }
      v += acc;
    }
    if (residual != nullptr) v += to_f(residual[n * C + c]);
    ((T*)a.out)[n * C + c] = from_f<T>(v);
  }
}

// Tile, splits and scratch of one chain call.
struct FfnPlan {
  bool large_gate, large_out;
  Split gate, out;
  size_t gate_floats, out_floats;
};

inline FfnPlan ffn_plan(int N, int C, int M) {
  FfnPlan p;
  p.large_gate = use_large_tile(N, M);
  p.large_out = use_large_tile(N, C);
  const int gbm = p.large_gate ? TileL::BM : TileS::BM, gbn = p.large_gate ? TileL::BN : TileS::BN;
  const int obm = p.large_out ? TileL::BM : TileS::BM, obn = p.large_out ? TileL::BN : TileS::BN;
  p.gate = choose_split(3 * ((M + gbn - 1) / gbn) * ((N + gbm - 1) / gbm), (C + BK - 1) / BK);
  p.out = choose_split(((C + obn - 1) / obn) * ((N + obm - 1) / obm), 3 * ((M + BK - 1) / BK));
  p.gate_floats = p.gate.splits > 1 ? (size_t)3 * p.gate.splits * 2 * N * M : 0;
  p.out_floats = (size_t)p.out.splits * N * C;
  return p;
}

template <typename T, typename S>
void launch_gate(const FfnArgs& a, Split sp, cudaStream_t st) {
  dim3 grid((a.M + S::BN - 1) / S::BN, (a.N + S::BM - 1) / S::BM, 3 * sp.splits);
  if (sp.splits > 1) {
    gate_kernel<T, S, true><<<grid, S::THREADS, 0, st>>>(a, sp);
    const size_t n = (size_t)3 * a.N * a.M;
    gate_finish_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, sp.splits);
  } else {
    gate_kernel<T, S, false><<<grid, S::THREADS, 0, st>>>(a, sp);
  }
}

template <typename T, typename S>
void launch_out(const FfnArgs& a, Split sp, float* part, cudaStream_t st) {
  dim3 grid((a.C + S::BN - 1) / S::BN, (a.N + S::BM - 1) / S::BM, sp.splits);
  out_partial_kernel<T, S><<<grid, S::THREADS, 0, st>>>(a, sp, part);
}

// The whole chain; conv.kernel == nullptr leaves the conv branch out.
// B = images (conv only). Returns the first CUDA error.
template <typename T>
int ffn_chain(FfnArgs a, const ConvArgs& conv, int B, const void* residual, cudaStream_t st) {
  const FfnPlan p = ffn_plan(a.N, a.C, a.M);
  float* gate_part = a.scratch;
  float* out_part = a.scratch + p.gate_floats;
  norm_film_kernel<T><<<(a.N * 32 + 255) / 256, 256, 0, st>>>(
      (const T*)a.x, (const T*)a.mul, (const T*)a.bias, a.N, a.C, a.film_rows, 1e-4f, (T*)a.h);
  a.scratch = gate_part;
  if (p.large_gate) launch_gate<T, TileL>(a, p.gate, st);
  else launch_gate<T, TileS>(a, p.gate, st);
  if (p.large_out) launch_out<T, TileL>(a, p.out, out_part, st);
  else launch_out<T, TileS>(a, p.out, out_part, st);
  const dim3 block(32, 8);
  const unsigned groups = (a.C + kGroup - 1) / kGroup;
  if (conv.kernel != nullptr) {
    const size_t smem = conv_smem_bytes(conv.W);
    cudaError_t e = allow_smem(finish_kernel<T, true>, smem);
    if (e != cudaSuccess) return (int)e;
    finish_kernel<T, true><<<dim3(groups, B * conv.H), block, smem, st>>>(
        a, conv, out_part, p.out.splits, (const T*)residual);
  } else {
    finish_kernel<T, false><<<dim3(groups, (a.N + 31) / 32), block, 0, st>>>(
        a, conv, out_part, p.out.splits, (const T*)residual);
  }
  return (int)cudaGetLastError();
}

}  // namespace ldm

// fp32 scratch (partial sums) one chain call needs, for the wrapper.
extern "C" long long ffn_scratch_floats(int N, int C, int M) {
  const ldm::FfnPlan p = ldm::ffn_plan(N, C, M);
  return (long long)(p.gate_floats + p.out_floats);
}
