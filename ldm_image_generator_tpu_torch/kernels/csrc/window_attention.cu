// Windowed multi-head self-attention, the Hopper counterpart of
// window_mha_pallas. On x [N, L, C] (N windows of L tokens), three
// launches:
//   1. qkv = T(x @ [wq | wk | wv] + [bq | bk | bv])        -> [N, L, 3C]
//   2. per (window, head): s = q k^T / sqrt(d) (+ -1e9 on padded keys),
//      p = T(softmax(s)) in fp32, o = T(p v)              -> [N, L, C]
//   3. out = T(o @ wo + bo)
// The three projection weights are read in place (no concatenated copy);
// at few rows the projections split k over blocks (common.cuh). qkv, o
// and the fp32 partial sums live in scratch the Python wrapper allocates.
// dtype: 0 = float32, 1 = bfloat16.
#include "common.cuh"

namespace ldm {

// Up to three projections of one input: segment z writes
// out[:, off_z : off_z + cols] = T(A @ W_z + b_z), out row stride ldo.
template <typename T>
struct ProjArgs {
  const T* A;
  int rows, K, cols;
  const T* w[3];
  const T* b[3];
  int off[3];
  T* out;
  int ldo;
  float* part;  // fp32 partial sums [nseg * splits, rows, cols] when split
};

// grid (ceil(cols / BN), ceil(rows / BM), nseg * split.splits).
template <typename T, typename S, bool SPLIT>
__global__ void __launch_bounds__(S::THREADS)
proj_kernel(ProjArgs<T> p, Split split) {
  const int z = blockIdx.z / split.splits, s = blockIdx.z % split.splits;
  __shared__ TileSmem<S, 1> sm;
  float acc[1][S::TM][S::TN];
  zero_acc<S, 1>(acc);
  const T* B[1] = {p.w[z]};
  const int k_end = min(p.K, (s + 1) * split.per * BK);
  tile_product<S, 1>(p.A, p.K, p.rows, p.K, blockIdx.y * S::BM, B, p.cols, p.cols,
                     blockIdx.x * S::BN, s * split.per * BK, k_end, sm, acc);
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = acc_row<S>(i);
    if (row >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int col = acc_col<S>(j);
      if (col >= p.cols) continue;
      if (SPLIT)
        p.part[((size_t)blockIdx.z * p.rows + row) * p.cols + col] = acc[0][i][j];
      else
        p.out[(size_t)row * p.ldo + p.off[z] + col] = from_f<T>(acc[0][i][j] + to_f(p.b[z][col]));
    }
  }
}

// The split partial sums of proj_kernel, plus bias, rounded once.
template <typename T>
__global__ void proj_finish_kernel(ProjArgs<T> p, int nseg, int splits) {
  const size_t rc = (size_t)p.rows * p.cols;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nseg * rc) return;
  const int z = idx / rc;
  const size_t o = idx % rc;
  const int row = o / p.cols, col = o % p.cols;
  float v = to_f(p.b[z][col]);
  for (int s = 0; s < splits; ++s) v += p.part[(size_t)(z * splits + s) * rc + o];
  p.out[(size_t)row * p.ldo + p.off[z] + col] = from_f<T>(v);
}

struct ProjPlan {
  bool large;
  Split split;
  size_t floats;
};

inline ProjPlan proj_plan(int rows, int K, int cols, int nseg) {
  ProjPlan p;
  p.large = use_large_tile(rows, cols * nseg);
  const int bm = p.large ? TileL::BM : TileS::BM, bn = p.large ? TileL::BN : TileS::BN;
  p.split = choose_split(nseg * ((cols + bn - 1) / bn) * ((rows + bm - 1) / bm),
                         (K + BK - 1) / BK);
  p.floats = p.split.splits > 1 ? (size_t)nseg * p.split.splits * rows * cols : 0;
  return p;
}

// grid (heads, N); dynamic shared memory attn_smem_bytes(L, d).
template <typename T>
__global__ void attn_core_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                                 int L, int C, int d, float scale, T* __restrict__ o) {
  extern __shared__ float sm[];
  float* q = sm;               // [L][d]
  float* k = q + L * d;        // [L][d + 1]
  float* v = k + L * (d + 1);  // [L][d]
  float* s = v + L * d;        // [L][L + 1]
  const int head = blockIdx.x, n = blockIdx.y;
  const int C3 = 3 * C;
  for (int idx = threadIdx.x; idx < L * d; idx += blockDim.x) {
    const int l = idx / d, j = idx % d;
    const size_t base = ((size_t)n * L + l) * C3 + head * d + j;
    q[l * d + j] = to_f(qkv[base]);
    k[l * (d + 1) + j] = to_f(qkv[base + C]);
    v[l * d + j] = to_f(qkv[base + 2 * C]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * L; idx += blockDim.x) {
    const int i = idx / L, j = idx % L;
    float acc = 0.f;
    for (int t = 0; t < d; ++t) acc = fmaf(q[i * d + t], k[j * (d + 1) + t], acc);
    acc *= scale;
    if (mask != nullptr && mask[(size_t)n * L + j]) acc += -1e9f;
    s[i * (L + 1) + j] = acc;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int i = warp; i < L; i += nwarps) {
    float* row = s + i * (L + 1);
    float m = __int_as_float((int)0xff800000);  // -inf
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // probs are rounded to the working type before the value product
    for (int j = lane; j < L; j += 32) row[j] = to_f(from_f<T>(row[j] / sum));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * d; idx += blockDim.x) {
    const int i = idx / d, j = idx % d;
    float acc = 0.f;
    for (int t = 0; t < L; ++t) acc = fmaf(s[i * (L + 1) + t], v[t * d + j], acc);
    o[((size_t)n * L + i) * C + head * d + j] = from_f<T>(acc);
  }
}

inline size_t attn_smem_bytes(int L, int d) {
  return sizeof(float) * ((size_t)L * d * 2 + (size_t)L * (d + 1) + (size_t)L * (L + 1));
}

template <typename T, typename S>
void launch_proj(const ProjArgs<T>& p, int nseg, Split sp, cudaStream_t st) {
  dim3 grid((p.cols + S::BN - 1) / S::BN, (p.rows + S::BM - 1) / S::BM, nseg * sp.splits);
  if (sp.splits > 1) {
    proj_kernel<T, S, true><<<grid, S::THREADS, 0, st>>>(p, sp);
    const size_t n = (size_t)nseg * p.rows * p.cols;
    proj_finish_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(p, nseg, sp.splits);
  } else {
    proj_kernel<T, S, false><<<grid, S::THREADS, 0, st>>>(p, sp);
  }
}

template <typename T>
void proj(const ProjArgs<T>& p, int nseg, cudaStream_t st) {
  const ProjPlan plan = proj_plan(p.rows, p.K, p.cols, nseg);
  if (plan.large) launch_proj<T, TileL>(p, nseg, plan.split, st);
  else launch_proj<T, TileS>(p, nseg, plan.split, st);
}

template <typename T>
int window_mha(const void* x, const uint8_t* mask, const void* wq, const void* bq,
               const void* wk, const void* bk, const void* wv, const void* bv, const void* wo,
               const void* bo, int N, int L, int C, int heads, void* qkv, void* o, void* out,
               float* scratch, cudaStream_t st) {
  const int rows = N * L, d = C / heads;
  const ProjArgs<T> in{(const T*)x, rows, C, C,
                       {(const T*)wq, (const T*)wk, (const T*)wv},
                       {(const T*)bq, (const T*)bk, (const T*)bv},
                       {0, C, 2 * C}, (T*)qkv, 3 * C, scratch};
  proj<T>(in, 3, st);
  const size_t smem = attn_smem_bytes(L, d);
  cudaError_t e = allow_smem(attn_core_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  attn_core_kernel<T><<<dim3(heads, N), 128, smem, st>>>(
      (const T*)qkv, mask, L, C, d, 1.0f / sqrtf((float)d), (T*)o);
  const ProjArgs<T> op{(const T*)o, rows, C, C, {(const T*)wo, nullptr, nullptr},
                       {(const T*)bo, nullptr, nullptr}, {0, 0, 0}, (T*)out, C, scratch};
  proj<T>(op, 1, st);
  return (int)cudaGetLastError();
}

}  // namespace ldm

extern "C" int window_mha_forward(int dtype, const void* x, const void* mask, const void* wq,
                                  const void* bq, const void* wk, const void* bk,
                                  const void* wv, const void* bv, const void* wo,
                                  const void* bo, int N, int L, int C, int heads, void* qkv,
                                  void* o, void* out, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 0)
    return ldm::window_mha<float>(x, m, wq, bq, wk, bk, wv, bv, wo, bo, N, L, C, heads, qkv, o,
                                  out, (float*)scratch, st);
  if (dtype == 1)
    return ldm::window_mha<__nv_bfloat16>(x, m, wq, bq, wk, bk, wv, bv, wo, bo, N, L, C, heads,
                                          qkv, o, out, (float*)scratch, st);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one attention block needs, for the wrapper's check.
extern "C" long long window_mha_smem_bytes(int L, int d) {
  return (long long)ldm::attn_smem_bytes(L, d);
}

// fp32 scratch (split partial sums) one call needs, for the wrapper.
extern "C" long long window_mha_scratch_floats(int N, int L, int C) {
  const size_t a = ldm::proj_plan(N * L, C, C, 3).floats;
  const size_t b = ldm::proj_plan(N * L, C, C, 1).floats;
  return (long long)(a > b ? a : b);
}
