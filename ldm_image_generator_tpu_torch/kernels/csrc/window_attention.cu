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
//
// The backward (window_mha_backward, the counterpart of
// window_mha_bwd_pallas) recomputes qkv, then per (window, head) the
// probabilities, and emits dx and fp32 weight gradients; see
// attn_bwd_kernel below. dtype: 0 = float32, 1 = bfloat16.
#include "common.cuh"
#include "grad_common.cuh"

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

// Backward of one (window, head), grid (heads, N), dynamic shared memory
// attn_bwd_smem_bytes(L, d). With q, k, v the rounded recompute and dO =
// T(g @ wo^T) (all [L, d] slices of this head):
//   P = softmax(q k^T / sqrt(d) + mask) in fp32, Pt = T(P)
//   o  = T(Pt v)                  (the forward's attention output, for dwo)
//   dP = dO v^T                   (fp32)
//   dv = T(Pt^T dO)
//   dS = T(P * (dP - rowsum(dP * P)) / sqrt(d))
//   dq = T(dS k),  dk = T(dS^T q)
// written to o [N, L, C] and dqkv [N, L, 3C] at this head's columns.
template <typename T>
__global__ void attn_bwd_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                                const T* __restrict__ dout, int L, int C, int d, float scale,
                                T* __restrict__ o, T* __restrict__ dqkv) {
  extern __shared__ float sm[];
  float* q = sm;                  // [L][d]
  float* k = q + L * d;           // [L][d + 1]
  float* v = k + L * (d + 1);     // [L][d + 1]
  float* dO = v + L * (d + 1);    // [L][d]
  float* p = dO + L * d;          // [L][L + 1] fp32 probabilities
  float* dp = p + L * (L + 1);    // [L][L + 1] dP, then dS
  const int head = blockIdx.x, n = blockIdx.y;
  const int C3 = 3 * C;
  for (int idx = threadIdx.x; idx < L * d; idx += blockDim.x) {
    const int l = idx / d, j = idx % d;
    const size_t base = ((size_t)n * L + l) * C3 + head * d + j;
    q[l * d + j] = to_f(qkv[base]);
    k[l * (d + 1) + j] = to_f(qkv[base + C]);
    v[l * (d + 1) + j] = to_f(qkv[base + 2 * C]);
    dO[l * d + j] = to_f(dout[((size_t)n * L + l) * C + head * d + j]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * L; idx += blockDim.x) {
    const int i = idx / L, j = idx % L;
    float s = 0.f, t = 0.f;
    for (int u = 0; u < d; ++u) {
      s = fmaf(q[i * d + u], k[j * (d + 1) + u], s);
      t = fmaf(dO[i * d + u], v[j * (d + 1) + u], t);
    }
    s *= scale;
    if (mask != nullptr && mask[(size_t)n * L + j]) s += -1e9f;
    p[i * (L + 1) + j] = s;
    dp[i * (L + 1) + j] = t;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int i = warp; i < L; i += nwarps) {
    float* row = p + i * (L + 1);
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
    for (int j = lane; j < L; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();
  const size_t row0 = (size_t)n * L;
  for (int idx = threadIdx.x; idx < L * d; idx += blockDim.x) {
    const int i = idx / d, j = idx % d;
    float acc_o = 0.f, acc_v = 0.f;
    for (int t = 0; t < L; ++t) {
      acc_o = fmaf(to_f(from_f<T>(p[i * (L + 1) + t])), v[t * (d + 1) + j], acc_o);
      acc_v = fmaf(to_f(from_f<T>(p[t * (L + 1) + i])), dO[t * d + j], acc_v);
    }
    o[(row0 + i) * C + head * d + j] = from_f<T>(acc_o);
    dqkv[(row0 + i) * C3 + 2 * C + head * d + j] = from_f<T>(acc_v);
  }
  for (int i = warp; i < L; i += nwarps) {
    const float* pr = p + i * (L + 1);
    float* dr = dp + i * (L + 1);
    float rs = 0.f;
    for (int j = lane; j < L; j += 32) rs += dr[j] * pr[j];
    rs = warp_sum(rs);
    for (int j = lane; j < L; j += 32) dr[j] = to_f(from_f<T>(pr[j] * (dr[j] - rs) * scale));
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * d; idx += blockDim.x) {
    const int i = idx / d, j = idx % d;
    float acc_q = 0.f, acc_k = 0.f;
    for (int t = 0; t < L; ++t) {
      acc_q = fmaf(dp[i * (L + 1) + t], k[t * (d + 1) + j], acc_q);
      acc_k = fmaf(dp[t * (L + 1) + i], q[t * d + j], acc_k);
    }
    dqkv[(row0 + i) * C3 + head * d + j] = from_f<T>(acc_q);
    dqkv[(row0 + i) * C3 + C + head * d + j] = from_f<T>(acc_k);
  }
}

inline size_t attn_bwd_smem_bytes(int L, int d) {
  return sizeof(float) * ((size_t)2 * L * d + (size_t)2 * L * (d + 1) + (size_t)2 * L * (L + 1));
}

inline size_t attn_bwd_scratch_floats(int N, int L, int C) {
  const int rows = N * L;
  size_t f = proj_plan(rows, C, C, 3).floats;
  const size_t cand[3] = {abt_plan(1, rows, C, C).floats, abt_plan(3, rows, C, C).floats,
                          atb_part_floats(4, C, C, rows, 1)};
  for (size_t c : cand) f = c > f ? c : f;
  return f;
}

// grads: [dwq (C x C) | dbq (C)] [dwk | dbk] [dwv | dbv] [dwo | dbo], fp32.
template <typename T>
int window_mha_bwd(const void* x, const uint8_t* mask, const void* g, const void* wq,
                   const void* bq, const void* wk, const void* bk, const void* wv,
                   const void* bv, const void* wo, int N, int L, int C, int heads, void* dx,
                   void* qkv, void* o, void* dout, void* dqkv, float* grads, float* scratch,
                   cudaStream_t st) {
  const int rows = N * L, d = C / heads;
  const ProjArgs<T> in{(const T*)x, rows, C, C,
                       {(const T*)wq, (const T*)wk, (const T*)wv},
                       {(const T*)bq, (const T*)bk, (const T*)bv},
                       {0, C, 2 * C}, (T*)qkv, 3 * C, scratch};
  proj<T>(in, 3, st);
  // dO = T(g @ wo^T)
  AbtArgs pd{};
  pd.nseg = 1; pd.A[0] = g; pd.lda[0] = C; pd.B[0] = WeightRef{wo, -1, 0}; pd.ldb = C;
  pd.N = rows; pd.K = C; pd.ncol = C; pd.out = dout; pd.part = scratch;
  abt<T>(pd, st);
  const size_t smem = attn_bwd_smem_bytes(L, d);
  cudaError_t e = allow_smem(attn_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_kernel<T><<<dim3(heads, N), 128, smem, st>>>(
      (const T*)qkv, mask, (const T*)dout, L, C, d, 1.0f / sqrtf((float)d), (T*)o, (T*)dqkv);
  // dx = T(dq wq^T + dk wk^T + dv wv^T), one rounding
  AbtArgs px{};
  px.nseg = 3;
  const void* w3[3] = {wq, wk, wv};
  for (int z = 0; z < 3; ++z) {
    px.A[z] = (const T*)dqkv + z * C;
    px.lda[z] = 3 * C;
    px.B[z] = WeightRef{w3[z], -1, 0};
  }
  px.ldb = C; px.N = rows; px.K = C; px.ncol = C; px.out = dx; px.part = scratch;
  abt<T>(px, st);
  // weight gradients over the rows: x^T [dq | dk | dv] and o^T g, with
  // the bias gradients as the ones-row
  AtbArgs w{};
  w.nmat = 4;
  for (int z = 0; z < 4; ++z) {
    w.A[z] = z < 3 ? x : o;
    w.lda[z] = C;
    w.B[z] = z < 3 ? (const void*)((const T*)dqkv + z * C) : g;
    w.ldb[z] = z < 3 ? 3 * C : C;
    w.out[z] = grads + (size_t)z * (C + 1) * C;
  }
  w.K = rows; w.R = C; w.ncol = C; w.ones = 1; w.part = scratch;
  atb<T>(w, st);
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

extern "C" int window_mha_backward(int dtype, const void* x, const void* mask, const void* g,
                                   const void* wq, const void* bq, const void* wk,
                                   const void* bk, const void* wv, const void* bv,
                                   const void* wo, int N, int L, int C, int heads, void* dx,
                                   void* qkv, void* o, void* dout, void* dqkv, void* grads,
                                   void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 0)
    return ldm::window_mha_bwd<float>(x, m, g, wq, bq, wk, bk, wv, bv, wo, N, L, C, heads, dx,
                                      qkv, o, dout, dqkv, (float*)grads, (float*)scratch, st);
  if (dtype == 1)
    return ldm::window_mha_bwd<__nv_bfloat16>(x, m, g, wq, bq, wk, bk, wv, bv, wo, N, L, C,
                                              heads, dx, qkv, o, dout, dqkv, (float*)grads,
                                              (float*)scratch, st);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one backward attention block needs, for the wrapper's check.
extern "C" long long window_mha_bwd_smem_bytes(int L, int d) {
  return (long long)ldm::attn_bwd_smem_bytes(L, d);
}

// fp32 scratch (split partial sums) one backward call needs.
extern "C" long long window_mha_bwd_scratch_floats(int N, int L, int C) {
  return (long long)ldm::attn_bwd_scratch_floats(N, L, C);
}
