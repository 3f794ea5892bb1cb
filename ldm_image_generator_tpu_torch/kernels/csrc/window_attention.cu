// Windowed multi-head self-attention, the Hopper counterpart of
// window_mha_pallas (ldm_image_generator_tpu/kernels/window_attention.py)
// and, for gradients, of window_mha_bwd_pallas. On x [N, L, C] (N windows
// of L tokens, heads of d channels), with T() a rounding to the working
// type:
//   q, k, v = T(x @ wq + bq), T(x @ wk + bk), T(x @ wv + bv)
//   p = T(softmax(q k^T / sqrt(d) + mask)) (fp32 scores), o = T(p v)
//   out = T(o @ wo + bo)
// dtype: 0 = float32, 1 = bfloat16.
//
// bfloat16 runs on the tensor cores (namespace wtc, mma_common.cuh):
// every product is mma.sync m16n8k16 with fp32 accumulators, operands by
// ldmatrix from a ring of cp.async stages.
//   What bounds a call on the H100: at the batch-1 shapes, latency (the
//   chain of dependent launches, the weight stream's first bytes, a
//   window's serial softmax); the four C x C weights are 0.1-8 MB and the
//   arithmetic a few hundred MFLOP. At the B=8 training shapes, the
//   projections: 22 N L C^2 FLOP in the backward, about 17 GFLOP per call
//   set, each (window, head) reading its window and weight columns again.
//   Forward, two launches: (1) one CTA per (window, head) projects the
//   window's tokens onto the head's 3d columns of [wq | wk | wv] (weights
//   read in place, tile by tile) and runs the attention on the result in
//   shared memory; when that gives fewer CTAs than SMs (batch 1 at
//   C >= 256), a cluster of 3 CTAs splits the head by projection (q, k,
//   v), each streaming a third of the weight columns and storing its
//   rounded result into rank 0's shared memory; (2) the output
//   projection, in 16 x 32 tiles at few rows with k split over blocks,
//   the splits summed by the last block to arrive (split_fixup: fixed
//   order, no second launch). (2) is a programmatic dependent launch: it
//   streams its first wo tiles while (1) finishes.
//   Backward, two launches: (1) one CTA per (window, head) recomputes q,
//   k, v, projects dO = T(g wo^T), and forms o, dv, dS, dq and dk (the
//   train shapes give 256-1152 such CTAs, so no cluster); (2) one
//   dependent launch holding both dx = T(dqkv [wq|wk|wv]^T) tiles (k split
//   at large C) and the four weight gradients x^T [dq|dk|dv], o^T g (bias
//   gradients as column sums of the same tiles) split over the rows, all
//   summed with split_fixup, so reruns are bitwise equal.
//   It takes d = 32 (every head of the UNet) and L <= 64 (windows up to
//   8 x 8); other bfloat16 shapes take the FMA route below, by shape.
//
// float32 runs on the tensor cores too at the same shapes, forward and
// backward (namespace wtf): the same two launches each way, every product
// as three TF32 passes over fp32 tiles (tf32_common.cuh), fp32 accurate,
// the softmax and its backward in fp32 on the CUDA cores. Both types at
// other shapes keep the CUDA-core FMA tiles of common.cuh and
// grad_common.cuh: three launches forward
// (qkv projection, one block per (window, head) holding q, k, v and the
// scores in fp32 shared memory, output projection; k split over blocks
// with a summing pass at few rows) and the backward chain of
// window_mha_bwd below.
#include "common.cuh"
#include "grad_common.cuh"
#include "mma_common.cuh"
#include "tf32_common.cuh"

#include <cooperative_groups.h>

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

// ---------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------
namespace wtc {

using tc::bf16;

constexpr int D = 32;        // head width this route takes
constexpr int LMAX = 64;     // tokens per window it takes
using tc::BK;       // k-tile depth (64)
using tc::THREADS;  // 128
using tc::store2;
constexpr int STAGES = 3;
constexpr int QKV = 3 * D;   // one head's q, k, v columns
// shared-memory leading dimensions (elements), rows padded by 8
constexpr int LDX = BK + 8;     // token tile [LMAX][BK]
constexpr int LDW = QKV + 8;    // weight tile [BK][3d]
constexpr int LDH = D + 8;      // q, k, v, dO [LMAX][d]
constexpr int LDP = LMAX + 8;   // P, dS [LMAX][LMAX]
constexpr int X_EL = LMAX * LDX;
constexpr int STAGE_EL = X_EL + BK * LDW;
constexpr int RING_EL = STAGES * STAGE_EL;
constexpr int HEAD_EL = LMAX * LDH;
// The forward's q, k, v alias the ring when one CTA computes them and lie
// past it when a cluster does (other CTAs store into them while this one
// still streams); the backward keeps q, k, v, dO past the ring (the dO
// projection reuses it) and puts P, dS in it.
constexpr size_t FWD_SMEM = 2 * (RING_EL > 3 * HEAD_EL ? RING_EL : 3 * HEAD_EL);
constexpr size_t FWD_SMEM_CLUSTER = 2 * ((size_t)RING_EL + 3 * HEAD_EL);
constexpr size_t BWD_SMEM = 2 * ((size_t)RING_EL + 4 * HEAD_EL);
static_assert(2 * LMAX * LDP <= RING_EL, "P and dS fit in the ring");
static_assert(D * LDX <= BK * LDW, "the dO weight tile fits in a stage");

inline bool takes(int L, int d) { return d == D && L >= 1 && L <= LMAX; }

struct HeadArgs {
  const bf16* x;        // [N, L, C]
  const uint8_t* mask;  // [N, L] (1 = padded key) or null
  const bf16* w[4];     // wq, wk, wv, wo [C, C] ([in, out])
  const bf16* b[3];     // bq, bk, bv
  const bf16* g;        // out-cotangent [N, L, C] (backward)
  int L, C;
  int cs;               // forward: CTAs of a cluster splitting one head's projections
  float scale;
  bf16* o;              // [N, L, C]
  bf16* dqkv;           // [N, L, 3C] (backward)
};

// Bit j set: key j of the window is padded (mask). Every lane loads two
// flags (issued early, so the load overlaps the projections) and the
// ballot happens where the bits are needed.
struct KeyPad {
  bool lo, hi;
  template <class Args>
  __device__ __forceinline__ KeyPad(const Args& a, int n) {
    const int lane = threadIdx.x & 31;
    const uint8_t* m = a.mask ? a.mask + (size_t)n * a.L : nullptr;
    lo = m != nullptr && lane < a.L && m[lane];
    hi = m != nullptr && lane + 32 < a.L && m[lane + 32];
  }
  __device__ __forceinline__ uint64_t bits() const {
    return (uint64_t)__ballot_sync(0xffffffffu, lo) | (uint64_t)__ballot_sync(0xffffffffu, hi) << 32;
  }
};

// NSEG of the head's q, k, v column segments (d columns each, from
// segment `first` on) of window n: T(x_n @ w[:, cols] + b), rows >= L
// zero, into dst[segment] ([LMAX][LDH], local or another CTA's shared
// memory). Warp w owns columns [8 NSEG w, 8 NSEG (w + 1)) and every 16-row
// tile of the window.
template <int NSEG>
__device__ __forceinline__ void project_qkv(const HeadArgs& a, int n, int head, int mt, bf16* ring,
                                            int first, bf16* const (&dst)[3]) {
  constexpr int COLS = NSEG * D, LD = COLS + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = a.L, C = a.C, col0 = head * D;
  const bf16* xw = a.x + (size_t)n * L * C;
  float acc[4][NSEG][4];
  tc::zero<4, NSEG>(acc);
  auto load = [&](int buf, int kt) {
    bf16* xs = ring + buf * STAGE_EL;
    const int k0 = kt * BK;
    tc::load_tile<LMAX, BK, THREADS>(xs, LDX, 16 * mt, [&](int r, int c) -> const bf16* {
      return r < L && k0 + c < C ? xw + (size_t)r * C + k0 + c : nullptr;
    });
    tc::load_tile<BK, COLS, THREADS>(xs + X_EL, LD, BK, [&](int r, int c) -> const bf16* {
      return k0 + r < C ? a.w[first + c / D] + (size_t)(k0 + r) * C + col0 + c % D : nullptr;
    });
  };
  auto compute = [&](int buf) {
    const bf16* xs = ring + buf * STAGE_EL;
    tc::warp_mma<4, NSEG, false, false>(acc, xs, LDX, xs + X_EL, LD, 0, 8 * NSEG * warp, BK, mt);
  };
  tc::pipeline<STAGES>((C + BK - 1) / BK, load, compute);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NSEG; ++j) {
    const int col = 8 * NSEG * warp + 8 * j + 2 * t, seg = first + col / D, cc = col % D;
    const float b0 = to_f(a.b[seg][col0 + cc]), b1 = to_f(a.b[seg][col0 + cc + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        store2(dst[seg] + row * LDH + cc,
               row < L ? tc::pack_bf16(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1) : 0u);
      }
    }
  }
}

// dO of window n, head `head`: T(g_n @ wo[head rows, :]^T), rows >= L
// zero, into dos [LMAX][LDH]. Warp w owns the head's columns [8 w, 8 w + 8).
__device__ __forceinline__ void project_dout(const HeadArgs& a, int n, int head, int mt,
                                             bf16* ring, bf16* dos) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = a.L, C = a.C;
  const bf16* gw = a.g + (size_t)n * L * C;
  const bf16* wrows = a.w[3] + (size_t)head * D * C;
  float acc[4][1][4];
  tc::zero<4, 1>(acc);
  auto load = [&](int buf, int kt) {
    bf16* gs = ring + buf * STAGE_EL;
    const int k0 = kt * BK;
    tc::load_tile<LMAX, BK, THREADS>(gs, LDX, 16 * mt, [&](int r, int c) -> const bf16* {
      return r < L && k0 + c < C ? gw + (size_t)r * C + k0 + c : nullptr;
    });
    tc::load_tile<D, BK, THREADS>(gs + X_EL, LDX, D, [&](int r, int c) -> const bf16* {
      return k0 + c < C ? wrows + (size_t)r * C + k0 + c : nullptr;
    });
  };
  auto compute = [&](int buf) {
    const bf16* gs = ring + buf * STAGE_EL;
    tc::warp_mma<4, 1, false, true>(acc, gs, LDX, gs + X_EL, LDX, 0, 8 * warp, BK, mt);
  };
  tc::pipeline<STAGES>((C + BK - 1) / BK, load, compute);
  const int g = lane >> 2, t = lane & 3, col = 8 * warp + 2 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * i + g + 8 * h;
      store2(dos + row * LDH + col,
             row < L ? tc::pack_bf16(acc[i][0][2 * h], acc[i][0][2 * h + 1]) : 0u);
    }
  }
}

// The forward's projections of one (window, head): q, k, v into this
// CTA's qs, ks, vs. With a.cs == 1 this CTA computes them all. Otherwise
// a cluster of 3 CTAs splits them by columns, rank r computing segment r
// (q, k or v) over the whole of C and storing it, rounded, into rank 0's
// shared memory; no partial sums cross CTAs. Returns whether this CTA
// goes on to the attention (rank 0); its q, k, v are complete then.
__device__ __forceinline__ bool project_head(const HeadArgs& a, int n, int head, int mt, bf16* ring,
                                             bf16* qs, bf16* ks, bf16* vs) {
  if (a.cs == 1) {
    bf16* const dst[3] = {qs, ks, vs};
    project_qkv<3>(a, n, head, mt, ring, 0, dst);
    return true;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  bf16* const dst[3] = {cl.map_shared_rank(qs, 0), cl.map_shared_rank(ks, 0),
                        cl.map_shared_rank(vs, 0)};
  project_qkv<1>(a, n, head, mt, ring, rank, dst);
  cl.sync();  // every segment stored in rank 0
  return rank == 0;
}

// The scores p (q k^T of a warp's 16 query rows against the 16 mt keys,
// in the accumulator layout) in place as softmax(p * scale + mask) in
// fp32, exactly 0 at keys >= L.
__device__ __forceinline__ void softmax_scores(float (&p)[8][4], uint64_t padded, int L, int mt,
                                               float scale) {
  const int t = threadIdx.x & 3;
  const float ninf = __int_as_float((int)0xff800000);
  float mx[2] = {ninf, ninf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= 2 * mt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t + (e & 1);
      float s = p[j][e] * scale;
      if (col >= L) s = ninf;
      else if ((padded >> col) & 1) s += -1e9f;
      p[j][e] = s;
      mx[e >> 1] = fmaxf(mx[e >> 1], s);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= 2 * mt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = expf(p[j][e] - mx[e >> 1]);
      p[j][e] = v;
      sum[e >> 1] += v;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], o);
  // one division per row (IEEE division per element takes its slow path
  // on the many zeros and costs microseconds)
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] *= inv[e >> 1];
}

// Probabilities of query rows [16 w, 16 w + 16) against the 16 mt keys:
// softmax(q k^T * scale + mask) in fp32 in this warp's accumulator
// layout (p[j]: keys 8 j..), exactly 0 at keys >= L.
__device__ __forceinline__ void softmax_rows(float (&p)[8][4], const bf16* qs, const bf16* ks,
                                             uint64_t padded, int L, int mt, float scale, int w) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[4];
    tc::frag_a<false>(a, qs, LDH, 16 * w, k0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj >= mt) continue;
      uint32_t b[4];
      tc::frag_b2<true>(b, ks, LDH, k0, 16 * jj);
      tc::mma16816(p[2 * jj], a, b[0], b[1]);
      tc::mma16816(p[2 * jj + 1], a, b[2], b[3]);
    }
  }
  softmax_scores(p, padded, L, mt, scale);
}

// T(p) as A fragments: key block kk is p[2 kk] and p[2 kk + 1].
__device__ __forceinline__ void p_frags(uint32_t (&pa)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = tc::pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = tc::pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = tc::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = tc::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// o rows [16 w, 16 w + 16) = T(T(p) v), written to a.o at this head's
// columns for rows < L.
__device__ __forceinline__ void write_pv(const HeadArgs& a, const uint32_t (&pa)[4][4],
                                         const bf16* vs, int n, int head, int mt, int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= mt) continue;
#pragma unroll
    for (int jd = 0; jd < 4; jd += 2) {
      uint32_t b[4];
      tc::frag_b2<false>(b, vs, LDH, 16 * kk, 8 * jd);
      tc::mma16816(acc[jd], pa[kk], b[0], b[1]);
      tc::mma16816(acc[jd + 1], pa[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * w + g + 8 * h;
    if (row >= a.L) continue;
    bf16* dst = a.o + ((size_t)n * a.L + row) * a.C + head * D + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j) store2(dst + 8 * j, tc::pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]));
  }
}

// grid (heads * a.cs, N) in clusters of a.cs CTAs; FWD_SMEM bytes of
// dynamic shared memory alone, FWD_SMEM_CLUSTER in a cluster.
__global__ void __launch_bounds__(THREADS) fwd_core_kernel(HeadArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* qs = a.cs == 1 ? ring : ring + RING_EL;  // aliases the drained ring when alone
  bf16 *ks = qs + HEAD_EL, *vs = ks + HEAD_EL;
  const int head = blockIdx.x / a.cs, n = blockIdx.y, mt = (a.L + 15) / 16;
  const int warp = threadIdx.x >> 5;
  tc::griddep_launch();  // the output projection may start streaming wo
  const KeyPad pad(a, n);
  if (!project_head(a, n, head, mt, ring, qs, ks, vs)) return;
  __syncthreads();
  if (warp >= mt) return;
  float p[8][4];
  softmax_rows(p, qs, ks, pad.bits(), a.L, mt, a.scale, warp);
  uint32_t pa[4][4];
  p_frags(pa, p);
  write_pv(a, pa, vs, n, head, mt, warp);
}

// grid (heads, N), BWD_SMEM bytes. With P the fp32 probabilities:
//   o  = T(T(P) v)                       (for dwo)
//   dP = dO v^T                          (fp32)
//   dS = T(P (dP - rowsum(dP P)) scale)
//   dv = T(T(P)^T dO), dq = T(dS k), dk = T(dS^T q)
// o to a.o, dq | dk | dv to a.dqkv at this head's columns.
__global__ void __launch_bounds__(THREADS) bwd_core_kernel(HeadArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16 *qs = ring + RING_EL, *ks = qs + HEAD_EL, *vs = ks + HEAD_EL, *dos = vs + HEAD_EL;
  bf16 *ps = ring, *dss = ps + LMAX * LDP;  // after both projections
  const int head = blockIdx.x, n = blockIdx.y, mt = (a.L + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int L = a.L, C = a.C;
  tc::griddep_launch();  // the tail may start streaming the weights
  const KeyPad pad(a, n);
  bf16* const qkv[3] = {qs, ks, vs};
  project_qkv<3>(a, n, head, mt, ring, 0, qkv);
  project_dout(a, n, head, mt, ring, dos);  // reuses the drained ring
  __syncthreads();
  if (warp < mt) {
    float p[8][4];
    softmax_rows(p, qs, ks, pad.bits(), L, mt, a.scale, warp);
    uint32_t pa[4][4];
    p_frags(pa, p);
    write_pv(a, pa, vs, n, head, mt, warp);
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t af[4];
      tc::frag_a<false>(af, dos, LDH, 16 * warp, k0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj >= mt) continue;
        uint32_t b[4];
        tc::frag_b2<true>(b, vs, LDH, k0, 16 * jj);
        tc::mma16816(dp[2 * jj], af, b[0], b[1]);
        tc::mma16816(dp[2 * jj + 1], af, b[2], b[3]);
      }
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[j][e] * p[j][e];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      const bool live = row < L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * mt) continue;
        const float d0 = p[j][2 * h] * (dp[j][2 * h] - rs[h]) * a.scale;
        const float d1 = p[j][2 * h + 1] * (dp[j][2 * h + 1] - rs[h]) * a.scale;
        store2(ps + row * LDP + 8 * j + 2 * t,
               live ? tc::pack_bf16(p[j][2 * h], p[j][2 * h + 1]) : 0u);
        store2(dss + row * LDP + 8 * j + 2 * t, live ? tc::pack_bf16(d0, d1) : 0u);
      }
    }
  }
  __syncthreads();
  // dv, dq, dk: (product, 16-row tile) units over the warps
  for (int u = warp; u < 3 * mt; u += THREADS / 32) {
    const int prod = u / mt, m0 = 16 * (u % mt);
    float acc[1][4][4];
    tc::zero<1, 4>(acc);
    if (prod == 0) tc::warp_mma<1, 4, true, false>(acc, ps, LDP, dos, LDH, m0, 0, 16 * mt);
    else if (prod == 1) tc::warp_mma<1, 4, false, false>(acc, dss, LDP, ks, LDH, m0, 0, 16 * mt);
    else tc::warp_mma<1, 4, true, false>(acc, dss, LDP, qs, LDH, m0, 0, 16 * mt);
    const int col = (prod == 0 ? 2 * C : prod == 1 ? 0 : C) + head * D + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + g + 8 * h;
      if (row >= L) continue;
      bf16* dst = a.dqkv + ((size_t)n * L + row) * 3 * C + col;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store2(dst + 8 * j, tc::pack_bf16(acc[0][j][2 * h], acc[0][j][2 * h + 1]));
    }
  }
}

using tc::Gemm;
using tc::for_pairs;
using tc::gemm_tile;
using Wide = Gemm<64, 64, 2, 2, 3>;    // many rows
using Narrow = Gemm<16, 32, 1, 4, 6>;  // few rows: more blocks, deeper ring

struct OutArgs {
  const bf16* o;   // [rows, C]
  const bf16* wo;  // [C, C]
  const bf16* bo;
  bf16* out;
  int rows, C, splits, per;  // k-tiles split over `splits` blocks, `per` each
  float* part;               // fp32 split partials
  int* counters;             // one per output tile, 0 between calls
};

// out = T(o @ wo + bo); grid (ceil(C / BN), ceil(rows / BM), splits).
template <class G>
__global__ void __launch_bounds__(THREADS) out_proj_kernel(OutArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int mb = blockIdx.y * G::BM, nb = blockIdx.x * G::BN, s = blockIdx.z;
  const int kt = (a.C + BK - 1) / BK, kt0 = s * a.per, kt1 = min(kt, kt0 + a.per);
  const int C = a.C, rows = a.rows;
  float acc[G::MI][G::NI][4];
  gemm_tile<G, false, false>(
      acc, ring, kt0, kt1,
      [&](int r, int c, int k0) -> const bf16* {
        return mb + r < rows && k0 + c < C ? a.o + (size_t)(mb + r) * C + k0 + c : nullptr;
      },
      [&](int r, int c, int k0) -> const bf16* {
        return k0 + r < C && nb + c < C ? a.wo + (size_t)(k0 + r) * C + nb + c : nullptr;
      },
      [](const bf16*, int) {}, [] { tc::griddep_wait(); });
  if (a.splits > 1) {
    float none[1];
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const size_t per_split = (size_t)G::BM * G::BN;
    if (!tc::split_fixup<THREADS, G::MI, G::NI, 0>(acc, none, a.part + tile * a.splits * per_split,
                                                   a.splits, s, a.counters + tile))
      return;
  }
  for_pairs<G>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    if (row < rows && col < C)
      store2(a.out + (size_t)row * C + col,
             tc::pack_bf16(v0 + to_f(a.bo[col]), v1 + to_f(a.bo[col + 1])));
  });
}

using tc::sm_count;

struct OutPlan {
  bool narrow;
  dim3 grid;
  int splits, per;
  size_t floats;  // fp32 split partials
  int tiles;      // counters used
};

inline OutPlan out_plan(int rows, int C) {
  OutPlan p;
  const int kt = (C + BK - 1) / BK, sms = sm_count();
  p.narrow = ((rows + Wide::BM - 1) / Wide::BM) * ((C + Wide::BN - 1) / Wide::BN) < sms;
  const int bm = p.narrow ? Narrow::BM : Wide::BM, bn = p.narrow ? Narrow::BN : Wide::BN;
  const int tm = (rows + bm - 1) / bm, tn = (C + bn - 1) / bn;
  p.tiles = tm * tn;
  int s = 1;
  if (p.tiles < sms) {  // k split until the card has a block per SM, >= 4 k-tiles each
    s = (sms + p.tiles - 1) / p.tiles;
    s = s < kt / 4 ? s : kt / 4;
    s = s > 1 ? s : 1;
  }
  p.per = (kt + s - 1) / s;
  p.splits = (kt + p.per - 1) / p.per;
  p.grid = dim3(tn, tm, p.splits);
  p.floats = p.splits > 1 ? (size_t)p.tiles * p.splits * bm * bn : 0;
  return p;
}

// T: bf16 here, float on wtf's route
template <typename T>
struct TailArgsT {
  const T *x, *g, *o, *dqkv;     // [rows, C] (dqkv [rows, 3C])
  const T* w[3];                 // wq, wk, wv
  T* dx;                         // [rows, C]
  float* grads;                  // 4 x [(C + 1), C]: dW rows, then the bias
  int rows, C;
  int tn;                        // 64-wide tiles along C
  int dx_splits, dx_per, n_dx;   // dx blocks: tiles x splits of k = 3C
  int splits, per, dw_tiles;     // weight-gradient blocks: tiles x splits of the rows
  int n_dw, dx_first;            // the kind with more k-tiles a block is scheduled first
  float *part, *dx_part;         // split partials: dW's, dx's
  int* counters;                 // dW tiles', then dx tiles'
};
using TailArgs = TailArgsT<bf16>;

// n_dx blocks: dx = T(dq wq^T + dk wk^T + dv wv^T) in 64 x 64 tiles,
// k = 3C split dx_splits ways. n_dw blocks: the weight gradients, z = q,
// k, v, o: grads_z[:C] = A_z^T B_z, grads_z[C] = column sums of B_z,
// (A, B) = (x, dq | dk | dv) or (o, g), over the rows split `splits`
// ways. Splits meet in split_fixup, in a fixed order. The kind whose
// blocks run more k-tiles comes first in the grid, so that the shorter
// ones fill the last wave.
__global__ void __launch_bounds__(THREADS) bwd_tail_kernel(TailArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  using G = Wide;
  constexpr int TILE = G::BM * G::BN;
  const int C = a.C, rows = a.rows;
  float acc[G::MI][G::NI][4];
  const int id = blockIdx.x;
  const bool dx = a.dx_first ? id < a.n_dx : id >= a.n_dw;
  if (dx) {
    const int b = a.dx_first ? id : id - a.n_dw;
    const int s = b % a.dx_splits, tile = b / a.dx_splits;
    const int mb = (tile / a.tn) * G::BM, nb = (tile % a.tn) * G::BN;
    const int K = 3 * C, kt = (K + BK - 1) / BK;
    const int kt0 = min(kt, s * a.dx_per), kt1 = min(kt, kt0 + a.dx_per);
    gemm_tile<G, false, true>(
        acc, ring, kt0, kt1,
        [&](int r, int c, int k0) -> const bf16* {
          return mb + r < rows && k0 + c < K ? a.dqkv + (size_t)(mb + r) * K + k0 + c : nullptr;
        },
        [&](int r, int c, int k0) -> const bf16* {
          const int k = k0 + c;
          return nb + r < C && k < K ? a.w[k / C] + (size_t)(nb + r) * C + k % C : nullptr;
        },
        [](const bf16*, int) {}, [] { tc::griddep_wait(); });
    if (a.dx_splits > 1) {
      float none[1];
      if (!tc::split_fixup<THREADS, G::MI, G::NI, 0>(acc, none,
                                                     a.dx_part + (size_t)tile * a.dx_splits * TILE,
                                                     a.dx_splits, s, a.counters + a.dw_tiles + tile))
        return;
    }
    for_pairs<G>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
      if (row < rows && col < C) store2(a.dx + (size_t)row * C + col, tc::pack_bf16(v0, v1));
    });
    return;
  }
  const int b = a.dx_first ? id - a.n_dx : id, s = b % a.splits, tile = b / a.splits;
  const int per_z = a.tn * a.tn, z = tile / per_z;
  const int mb = ((tile % per_z) / a.tn) * G::BM, nb = (tile % a.tn) * G::BN;
  const bf16* A = z < 3 ? a.x : a.o;
  const bf16* B = z < 3 ? a.dqkv + z * C : a.g;
  const int ldb = z < 3 ? 3 * C : C;
  const int kt = (rows + BK - 1) / BK, kt0 = min(kt, s * a.per), kt1 = min(kt, kt0 + a.per);
  // bias gradient: the tiles of the first row block also sum B's columns;
  // thread t takes column t % 64 over half the k-tile's rows
  const bool bias = mb == 0;
  float cs[2] = {0.f, 0.f};
  // B (dq | dk | dv, or g) and o come from the core kernel: x streams in
  // before the wait, o after it
  if (z == 3) tc::griddep_wait();
  gemm_tile<G, true, false, true>(
      acc, ring, kt0, kt1,
      [&](int r, int c, int k0) -> const bf16* {
        return k0 + r < rows && mb + c < C ? A + (size_t)(k0 + r) * C + mb + c : nullptr;
      },
      [&](int r, int c, int k0) -> const bf16* {
        return k0 + r < rows && nb + c < C ? B + (size_t)(k0 + r) * ldb + nb + c : nullptr;
      },
      [&](const bf16* bs, int ld) {
        if (!bias) return;
        const int col = threadIdx.x % G::BN, r0 = (threadIdx.x / G::BN) * (BK / 2);
#pragma unroll 8
        for (int r = 0; r < BK / 2; ++r) cs[0] += to_f(bs[(r0 + r) * ld + col]);
      },
      [] { tc::griddep_wait(); });
  if (a.splits > 1 &&
      !tc::split_fixup<THREADS, G::MI, G::NI, 1>(
          acc, cs, a.part + (size_t)tile * a.splits * (TILE + THREADS), a.splits, s,
          a.counters + tile))
    return;
  float* out = a.grads + (size_t)z * (C + 1) * C;
  for_pairs<G>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    if (row < C && col < C)
      *reinterpret_cast<float2*>(out + (size_t)row * C + col) = make_float2(v0, v1);
  });
  if (bias) {
    __shared__ float half[G::BN];
    if (threadIdx.x >= G::BN) half[threadIdx.x - G::BN] = cs[0];
    __syncthreads();
    if (threadIdx.x < G::BN && nb + threadIdx.x < C)
      out[(size_t)C * C + nb + threadIdx.x] = cs[0] + half[threadIdx.x];
  }
}

struct TailPlan {
  int tn, dw_tiles, splits, per, n_dw;
  int dx_tiles, dx_splits, dx_per, n_dx;
  size_t dw_floats, floats;  // split partials: dW's, then dx's
};

inline TailPlan tail_plan(int rows, int C) {
  constexpr int TILE = Wide::BM * Wide::BN;
  TailPlan p;
  p.tn = (C + Wide::BN - 1) / Wide::BN;
  p.dw_tiles = 4 * p.tn * p.tn;
  const int kt = (rows + BK - 1) / BK, sms = sm_count();
  int s = 1;
  if (p.dw_tiles < 2 * sms) {  // two blocks per SM, >= 4 k-tiles each
    s = (2 * sms + p.dw_tiles - 1) / p.dw_tiles;
    s = s < kt / 4 ? s : kt / 4;
    s = s > 1 ? s : 1;
  }
  p.per = (kt + s - 1) / s;
  p.splits = (kt + p.per - 1) / p.per;
  p.n_dw = p.dw_tiles * p.splits;
  // dx: k = 3C in shares of at most 8 k-tiles, so no dx block outlasts
  // the weight-gradient blocks by much
  const int dx_kt = (3 * C + BK - 1) / BK;
  p.dx_tiles = ((rows + Wide::BM - 1) / Wide::BM) * p.tn;
  p.dx_per = dx_kt < 8 ? dx_kt : 8;
  p.dx_splits = (dx_kt + p.dx_per - 1) / p.dx_per;
  p.n_dx = p.dx_tiles * p.dx_splits;
  p.dw_floats = p.splits > 1 ? (size_t)p.dw_tiles * p.splits * (TILE + THREADS) : 0;
  p.floats = p.dw_floats + (p.dx_splits > 1 ? (size_t)p.dx_tiles * p.dx_splits * TILE : 0);
  return p;
}

// split-K counters the wrapper keeps zeroed (the kernels leave them 0)
constexpr int kCounters = 4096;

// The tail launch's arguments for plan p.
template <typename T>
inline TailArgsT<T> tail_args(const TailPlan& p, const void* x, const void* g, const void* o,
                              const void* dqkv, const void* wq, const void* wk, const void* wv,
                              void* dx, float* grads, int rows, int C, float* scratch,
                              int* counters) {
  TailArgsT<T> ta{};
  ta.x = (const T*)x; ta.g = (const T*)g; ta.o = (const T*)o; ta.dqkv = (const T*)dqkv;
  ta.w[0] = (const T*)wq; ta.w[1] = (const T*)wk; ta.w[2] = (const T*)wv;
  ta.dx = (T*)dx; ta.grads = grads; ta.rows = rows; ta.C = C; ta.tn = p.tn;
  ta.dx_splits = p.dx_splits; ta.dx_per = p.dx_per; ta.n_dx = p.n_dx;
  ta.splits = p.splits; ta.per = p.per; ta.dw_tiles = p.dw_tiles;
  ta.n_dw = p.n_dw; ta.dx_first = p.dx_per > p.per;
  ta.part = scratch; ta.dx_part = scratch + p.dw_floats;
  ta.counters = counters;
  return ta;
}

// Whether plan p's split counters fit in the kCounters the wrapper keeps.
inline bool tail_counters_fit(const TailPlan& p) {
  return p.dw_tiles + (p.dx_splits > 1 ? p.dx_tiles : 0) <= kCounters;
}

// CTAs per cluster splitting each (window, head)'s forward projections
// by columns: one per projection (q, k, v) when the grid would have fewer
// (window, head) blocks than the card has SMs (batch 1 at C >= 256: one
// SM alone issues a head's weight stream at a fraction of the memory's
// rate), else 1.
inline int cluster_size(int blocks) { return blocks < sm_count() ? 3 : 1; }

using tc::after_previous;
using tc::launch;

inline cudaLaunchAttribute cluster_of(int cs) {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = cs;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

inline HeadArgs head_args(const void* x, const uint8_t* mask, const void* wq, const void* bq,
                          const void* wk, const void* bk, const void* wv, const void* bv,
                          const void* wo, const void* g, int L, int C, int heads) {
  HeadArgs h{};
  h.x = (const bf16*)x;
  h.mask = mask;
  h.w[0] = (const bf16*)wq; h.w[1] = (const bf16*)wk; h.w[2] = (const bf16*)wv;
  h.w[3] = (const bf16*)wo;
  h.b[0] = (const bf16*)bq; h.b[1] = (const bf16*)bk; h.b[2] = (const bf16*)bv;
  h.g = (const bf16*)g;
  h.L = L; h.C = C;
  h.scale = 1.0f / sqrtf((float)(C / heads));
  return h;
}

inline int forward(const void* x, const uint8_t* mask, const void* wq, const void* bq,
                   const void* wk, const void* bk, const void* wv, const void* bv, const void* wo,
                   const void* bo, int N, int L, int C, int heads, void* o, void* out,
                   float* scratch, int* counters, cudaStream_t st) {
  if (!takes(L, C / heads) || C % heads) return (int)cudaErrorInvalidValue;
  HeadArgs h = head_args(x, mask, wq, bq, wk, bk, wv, bv, wo, nullptr, L, C, heads);
  h.o = (bf16*)o;
  h.cs = cluster_size(heads * N);
  cudaError_t e = launch(fwd_core_kernel, dim3(heads * h.cs, N),
                         h.cs == 1 ? FWD_SMEM : FWD_SMEM_CLUSTER, st, cluster_of(h.cs), h);
  if (e != cudaSuccess) return (int)e;
  const OutPlan p = out_plan(N * L, C);
  if (p.splits > 1 && p.tiles > kCounters) return (int)cudaErrorInvalidValue;
  const OutArgs oa{(const bf16*)o, (const bf16*)wo, (const bf16*)bo, (bf16*)out, N * L, C,
                   p.splits, p.per, scratch, counters};
  e = p.narrow ? launch(out_proj_kernel<Narrow>, p.grid, Narrow::smem<false, false>(), st,
                        after_previous(), oa)
               : launch(out_proj_kernel<Wide>, p.grid, Wide::smem<false, false>(), st,
                        after_previous(), oa);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

inline int backward(const void* x, const uint8_t* mask, const void* g, const void* wq,
                    const void* bq, const void* wk, const void* bk, const void* wv,
                    const void* bv, const void* wo, int N, int L, int C, int heads, void* dx,
                    void* o, void* dqkv, float* grads, float* scratch, int* counters,
                    cudaStream_t st) {
  if (!takes(L, C / heads) || C % heads) return (int)cudaErrorInvalidValue;
  HeadArgs h = head_args(x, mask, wq, bq, wk, bk, wv, bv, wo, g, L, C, heads);
  h.o = (bf16*)o;
  h.dqkv = (bf16*)dqkv;
  h.cs = 1;
  cudaError_t e = launch(bwd_core_kernel, dim3(heads, N), BWD_SMEM, st, cluster_of(1), h);
  if (e != cudaSuccess) return (int)e;
  const TailPlan p = tail_plan(N * L, C);
  if (!tail_counters_fit(p)) return (int)cudaErrorInvalidValue;
  const TailArgs ta =
      tail_args<bf16>(p, x, g, o, dqkv, wq, wk, wv, dx, grads, N * L, C, scratch, counters);
  constexpr size_t sm = Wide::smem<true, false>() > Wide::smem<false, true>()
                            ? Wide::smem<true, false>() : Wide::smem<false, true>();
  e = launch(bwd_tail_kernel, dim3(p.n_dw + p.n_dx), sm, st, after_previous(), ta);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace wtc

// ---------------------------------------------------------------------
// float32 on the tensor cores (three TF32 passes, tf32_common.cuh), the
// forward here, the backward after it: wtc's two launches with fp32 operands, the products
// fp32 accurate. The softmax stays fp32 on the CUDA cores, and the
// probabilities stay in registers: the product P v takes each 8-key block
// of P with its keys in the order 0 2 4 6 1 3 5 7 (the fragment's column
// t is key 2t, column t + 4 key 2t + 1), so a thread's accumulator
// elements are its A fragment, and v's rows are read in the same order.
// The projections stream 32-deep k-tiles (128 bytes a row, as bf16's 64)
// through a ring of 3: 22 KB a stage (14 KB for a cluster rank's one
// segment), 66 KB alone, 69 KB with a cluster's q, k, v, so three CTAs
// fit on an SM either way (bf16's 3 stages are 42 KB). The output
// projection is wtc's, with fp32 tiles (GemmF32) and the same plan,
// scratch and counters.
// ---------------------------------------------------------------------
namespace wtf {

using wtc::D;
using wtc::LMAX;
using tc::THREADS;
constexpr int KB = 32;      // k-tile depth of the q, k, v projections
constexpr int STAGES = 3;
// shared-memory leading dimensions (floats): A rows 4 mod 32, B rows 8
constexpr int LDX = KB + 4;       // token tile [LMAX][KB]
constexpr int LDH = D + 4;        // q, k, v [LMAX][d] (v read at rows 2t, 2t + 1: 8 t + 4 + g)
constexpr int X_EL = LMAX * LDX;
// a stage of the projection of NSEG segments: the token tile, then the
// weight tile [KB][NSEG d + 8]
template <int NSEG>
__host__ __device__ constexpr int stage_el() { return X_EL + KB * (NSEG * D + 8); }
constexpr int RING_EL = STAGES * stage_el<3>();   // a CTA alone
constexpr int RING1_EL = STAGES * stage_el<1>();  // a cluster rank
constexpr int HEAD_EL = LMAX * LDH;
constexpr size_t FWD_SMEM = 4 * (size_t)(RING_EL > 3 * HEAD_EL ? RING_EL : 3 * HEAD_EL);
constexpr size_t FWD_SMEM_CLUSTER = 4 * ((size_t)RING1_EL + 3 * HEAD_EL);
static_assert(LDX % 32 == 4 && LDH % 16 == 4, "conflict-free fragment loads");

struct HeadArgs {
  const float* x;       // [N, L, C]
  const uint8_t* mask;  // [N, L] (1 = padded key) or null
  const float* w[4];    // wq, wk, wv, wo [C, C] ([in, out]; wo for the backward)
  const float* b[3];    // bq, bk, bv
  const float* g;       // out-cotangent [N, L, C] (backward)
  int L, C;
  int cs;               // CTAs of a cluster splitting one head's projections
  float scale;
  float* o;             // [N, L, C]
  float* dqkv;          // [N, L, 3C] (backward)
};

// wtc::project_qkv in fp32: NSEG of the head's q, k, v column segments
// (from `first` on) of window n, x_n @ w[:, cols] + b, rows >= L zero,
// into dst[segment] ([LMAX][LDH]). Warp w owns columns [8 NSEG w, 8 NSEG
// (w + 1)) and every 16-row tile of the window.
template <int NSEG, int NST = STAGES>
__device__ __forceinline__ void project_qkv(const HeadArgs& a, int n, int head, int mt,
                                            float* ring, int first, float* const (&dst)[3]) {
  constexpr int COLS = NSEG * D, LD = COLS + 8, SE = stage_el<NSEG>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = a.L, C = a.C, col0 = head * D;
  const float* xw = a.x + (size_t)n * L * C;
  float acc[4][NSEG][4];
  tc::zero<4, NSEG>(acc);
  auto load = [&](int buf, int kt) {
    float* xs = ring + buf * SE;
    const int k0 = kt * KB;
    tc::load_tile_f32<LMAX, KB, THREADS>(xs, LDX, 16 * mt, [&](int r, int c) -> const float* {
      return r < L && k0 + c < C ? xw + (size_t)r * C + k0 + c : nullptr;
    });
    tc::load_tile_f32<KB, COLS, THREADS>(xs + X_EL, LD, KB, [&](int r, int c) -> const float* {
      return k0 + r < C ? a.w[first + c / D] + (size_t)(k0 + r) * C + col0 + c % D : nullptr;
    });
  };
  auto compute = [&](int buf) {
    const float* xs = ring + buf * SE;
    tc::warp_mma_f32<4, NSEG, false, true>(acc, xs, LDX, xs + X_EL, LD, 0, 8 * NSEG * warp, KB,
                                           mt);
  };
  tc::pipeline<NST>((C + KB - 1) / KB, load, compute);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NSEG; ++j) {
    const int col = 8 * NSEG * warp + 8 * j + 2 * t, seg = first + col / D, cc = col % D;
    const float b0 = a.b[seg][col0 + cc], b1 = a.b[seg][col0 + cc + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        const bool live = row < L;
        tc::store2f(dst[seg] + row * LDH + cc, live ? acc[i][j][2 * h] + b0 : 0.f,
                    live ? acc[i][j][2 * h + 1] + b1 : 0.f);
      }
    }
  }
}

// wtc::project_head in fp32: q, k, v of (window n, head) into this CTA's
// qs, ks, vs, by this CTA alone (a.cs == 1) or by a cluster of 3, rank r
// storing segment r into rank 0's shared memory. True on the CTA that
// goes on to the attention.
__device__ __forceinline__ bool project_head(const HeadArgs& a, int n, int head, int mt,
                                             float* ring, float* qs, float* ks, float* vs) {
  if (a.cs == 1) {
    float* const dst[3] = {qs, ks, vs};
    project_qkv<3>(a, n, head, mt, ring, 0, dst);
    return true;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  float* const dst[3] = {cl.map_shared_rank(qs, 0), cl.map_shared_rank(ks, 0),
                         cl.map_shared_rank(vs, 0)};
  project_qkv<1>(a, n, head, mt, ring, rank, dst);
  cl.sync();  // every segment stored in rank 0
  return rank == 0;
}

// Probabilities of query rows [16 w, 16 w + 16) against the 16 mt keys:
// softmax(q k^T * scale + mask) in fp32 in this warp's accumulator
// layout (p[j]: keys 8 j..), the scores one partial (d deep), exactly 0 at
// keys >= L.
__device__ __forceinline__ void softmax_rows(float (&p)[8][4], const float* qs, const float* ks,
                                             uint64_t padded, int L, int mt, float scale, int w) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 8) {
    tc::Frag<4> qa;
    tc::frag_a_f32(qa, qs, LDH, 16 * w, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= 2 * mt) continue;
      tc::Frag<2> kb;
      tc::frag_b_f32<true>(kb, ks, LDH, k0, 8 * j);
      tc::mma3(p[j], qa, kb);
    }
  }
  wtc::softmax_scores(p, padded, L, mt, scale);
}

// acc[jd] (columns 8 jd..) = p rows [key, 0:d) over the 16 mt keys, one
// partial: p (a warp's 16 rows by the keys, in the accumulator layout) is
// the A fragment with each 8-key block's keys in the order 0 2 4 6 1 3 5
// 7 (column t is key 2t, column t + 4 key 2t + 1), so rows is read at
// rows 2t and 2t + 1 of the block (rows [LMAX][LDH]: banks 8 t + g).
__device__ __forceinline__ void times_rows(float (&acc)[4][4], const float (&p)[8][4],
                                           const float* rows, int mt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk >= 2 * mt) continue;
    tc::Frag<4> pa;
    pa.set(0, p[kk][0]);
    pa.set(1, p[kk][2]);
    pa.set(2, p[kk][1]);
    pa.set(3, p[kk][3]);
    const float* r0 = rows + (8 * kk + 2 * t) * LDH + g;
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      tc::Frag<2> rb;
      rb.set(0, r0[8 * jd]);
      rb.set(1, r0[LDH + 8 * jd]);
      tc::mma3(acc[jd], pa, rb);
    }
  }
}

// acc's rows r0 + g, r0 + g + 8 below L, to dst (row stride ld) at
// columns 2t, 2t + 1 of each 8-column block.
__device__ __forceinline__ void store_rows(float* dst, int ld, const float (&acc)[4][4], int r0,
                                           int L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tc::store2f(dst + (size_t)row * ld + 8 * j + 2 * t, acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Query rows [16 w, 16 w + 16): o = softmax(q k^T * scale + mask) v,
// written to a.o at this head's columns for rows < L.
__device__ __forceinline__ void attend(const HeadArgs& a, const float* qs, const float* ks,
                                       const float* vs, uint64_t padded, int n, int head, int mt,
                                       int w) {
  float p[8][4], acc[4][4];
  softmax_rows(p, qs, ks, padded, a.L, mt, a.scale, w);
  times_rows(acc, p, vs, mt);
  store_rows(a.o + (size_t)n * a.L * a.C + head * D, a.C, acc, 16 * w, a.L);
}

// grid (heads * a.cs, N) in clusters of a.cs CTAs; FWD_SMEM bytes of
// dynamic shared memory alone, FWD_SMEM_CLUSTER in a cluster.
__global__ void __launch_bounds__(THREADS) fwd_core_kernel(HeadArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float* qs = a.cs == 1 ? ring : ring + RING1_EL;  // aliases the drained ring when alone
  float *ks = qs + HEAD_EL, *vs = ks + HEAD_EL;
  const int head = blockIdx.x / a.cs, n = blockIdx.y, mt = (a.L + 15) / 16;
  const int warp = threadIdx.x >> 5;
  tc::griddep_launch();  // the output projection may start streaming wo
  const wtc::KeyPad pad(a, n);
  if (!project_head(a, n, head, mt, ring, qs, ks, vs)) return;
  __syncthreads();
  const uint64_t padded = pad.bits();
  if (warp >= mt) return;
  attend(a, qs, ks, vs, padded, n, head, mt, warp);
}

using WideF = tc::GemmF32<64, 64, 2, 2, 3>;    // wtc::Wide's tile
using NarrowF = tc::GemmF32<16, 32, 1, 4, 6>;  // wtc::Narrow's
static_assert(WideF::BM == wtc::Wide::BM && WideF::BN == wtc::Wide::BN &&
                  NarrowF::BM == wtc::Narrow::BM && NarrowF::BN == wtc::Narrow::BN,
              "wtc::out_plan's tiles");

struct OutArgs {
  const float* o;   // [rows, C]
  const float* wo;  // [C, C]
  const float* bo;
  float* out;
  int rows, C, splits, per;
  float* part;
  int* counters;
};

// out = o @ wo + bo; grid (ceil(C / BN), ceil(rows / BM), splits).
template <class G>
__global__ void __launch_bounds__(THREADS) out_proj_kernel(OutArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mb = blockIdx.y * G::BM, nb = blockIdx.x * G::BN, s = blockIdx.z;
  const int kt = (a.C + tc::BK - 1) / tc::BK, kt0 = s * a.per, kt1 = min(kt, kt0 + a.per);
  const int C = a.C, rows = a.rows;
  float acc[G::MI][G::NI][4];
  tc::gemm_tile_f32<G>(
      acc, reinterpret_cast<float*>(smem_raw), kt0, kt1,
      [&](int r, int c, int k0) -> const float* {
        return mb + r < rows && k0 + c < C ? a.o + (size_t)(mb + r) * C + k0 + c : nullptr;
      },
      [&](int r, int c, int k0) -> const float* {
        return k0 + r < C && nb + c < C ? a.wo + (size_t)(k0 + r) * C + nb + c : nullptr;
      },
      [] { tc::griddep_wait(); });
  if (a.splits > 1) {
    float none[1];
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const size_t per_split = (size_t)G::BM * G::BN;
    if (!tc::split_fixup<THREADS, G::MI, G::NI, 0>(acc, none, a.part + tile * a.splits * per_split,
                                                   a.splits, s, a.counters + tile))
      return;
  }
  tc::for_pairs<G>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    if (row < rows && col < C)
      tc::store2f(a.out + (size_t)row * C + col, v0 + a.bo[col], v1 + a.bo[col + 1]);
  });
}

inline HeadArgs head_args(const void* x, const uint8_t* mask, const void* wq, const void* bq,
                          const void* wk, const void* bk, const void* wv, const void* bv,
                          const void* wo, const void* g, int L, int C, int heads) {
  HeadArgs h{};
  h.x = (const float*)x;
  h.mask = mask;
  h.w[0] = (const float*)wq; h.w[1] = (const float*)wk; h.w[2] = (const float*)wv;
  h.w[3] = (const float*)wo;
  h.b[0] = (const float*)bq; h.b[1] = (const float*)bk; h.b[2] = (const float*)bv;
  h.g = (const float*)g;
  h.L = L; h.C = C;
  h.scale = 1.0f / sqrtf((float)(C / heads));
  return h;
}

inline int forward(const void* x, const uint8_t* mask, const void* wq, const void* bq,
                   const void* wk, const void* bk, const void* wv, const void* bv, const void* wo,
                   const void* bo, int N, int L, int C, int heads, void* o, void* out,
                   float* scratch, int* counters, cudaStream_t st) {
  if (!wtc::takes(L, C / heads) || C % heads) return (int)cudaErrorInvalidValue;
  HeadArgs h = head_args(x, mask, wq, bq, wk, bk, wv, bv, nullptr, nullptr, L, C, heads);
  h.o = (float*)o;
  h.cs = wtc::cluster_size(heads * N);
  cudaError_t e = tc::launch(fwd_core_kernel, dim3(heads * h.cs, N),
                             h.cs == 1 ? FWD_SMEM : FWD_SMEM_CLUSTER, st, wtc::cluster_of(h.cs), h);
  if (e != cudaSuccess) return (int)e;
  const wtc::OutPlan p = wtc::out_plan(N * L, C);
  if (p.splits > 1 && p.tiles > wtc::kCounters) return (int)cudaErrorInvalidValue;
  const OutArgs oa{(const float*)o, (const float*)wo, (const float*)bo, (float*)out, N * L, C,
                   p.splits, p.per, scratch, counters};
  e = p.narrow ? tc::launch(out_proj_kernel<NarrowF>, p.grid, NarrowF::smem_bytes, st,
                            tc::after_previous(), oa)
               : tc::launch(out_proj_kernel<WideF>, p.grid, WideF::smem_bytes, st,
                            tc::after_previous(), oa);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// ---------------------------------------------------------------------
// The float32 backward: wtc's two launches with every product as three
// TF32 passes.
//   bwd_core_kernel, one CTA per (window, head): q, k, v (project_qkv, as
//   the forward), dO = g wo[head rows]^T through the same ring, then per
//   warp of 16 query rows P (fp32 softmax), o = P v, dP = dO v^T, dS = P
//   (dP - rowsum(dP P)) scale and dq = dS k, with P and dS in registers
//   as A fragments (their keys in the order 0 2 4 6 1 3 5 7, as the
//   forward's P v). dv = P^T dO and dk = dS^T q need P and dS as
//   transposed operands: they are stored [query][key] in fp32 (rows
//   padded 4 mod 32, in the drained ring) and read as A tiles stored
//   [k][m] with the k (query) index in pairs 2t, 2t + 1, dO and q read at
//   the same rows, every load conflict-free. 71 KB a CTA, three per SM
//   (164 registers): the projections stream through a ring of 2 (45 KB),
//   which then holds dO, P and dS, and q, k, v lie past it.
//   bwd_tail_kernel: wtc's tail with fp32 tiles (GemmF32), the same plan,
//   scratch and counters: dx = dqkv [wq|wk|wv]^T (the weights read in
//   place as B tiles stored [n][k]) and x^T [dq|dk|dv], o^T g (A_T tiles)
//   with the bias gradients as fp32 column sums, split and summed with
//   split_fixup in a fixed order.
// ---------------------------------------------------------------------
constexpr int LDP = LMAX + 4;  // P, dS [LMAX][LMAX + 4], read at rows 2t, 2t + 1
constexpr int BWD_STAGES = 2;
constexpr int BWD_RING_EL = BWD_STAGES * stage_el<3>();
constexpr size_t BWD_SMEM = 4 * ((size_t)BWD_RING_EL + 3 * HEAD_EL);
static_assert(2 * LMAX * LDP + HEAD_EL <= BWD_RING_EL, "P, dS and dO fit in the drained ring");
static_assert(X_EL + D * LDX <= stage_el<3>(), "the dO projection's stage fits in a stage");
static_assert(LDP % 32 == 4 && LDX % 32 == 4, "conflict-free fragment loads");

// dO of window n, head `head`: g_n @ wo[head rows, :]^T, rows >= L zero,
// into dos [LMAX][LDH] (which may lie in the ring: it is written once the
// ring has drained): 32-deep k-tiles of g and of wo's rows (a B tile
// stored [n][k]) through the ring of BWD_STAGES. Warp w owns the head's
// columns [8 w, 8 w + 8).
__device__ __forceinline__ void project_dout(const HeadArgs& a, int n, int head, int mt,
                                             float* ring, float* dos) {
  constexpr int SE = stage_el<3>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = a.L, C = a.C;
  const float* gw = a.g + (size_t)n * L * C;
  const float* wrows = a.w[3] + (size_t)head * D * C;
  float acc[4][1][4];
  tc::zero<4, 1>(acc);
  auto load = [&](int buf, int kt) {
    float* gs = ring + buf * SE;
    const int k0 = kt * KB;
    tc::load_tile_f32<LMAX, KB, THREADS>(gs, LDX, 16 * mt, [&](int r, int c) -> const float* {
      return r < L && k0 + c < C ? gw + (size_t)r * C + k0 + c : nullptr;
    });
    tc::load_tile_f32<D, KB, THREADS>(gs + X_EL, LDX, D, [&](int r, int c) -> const float* {
      return k0 + c < C ? wrows + (size_t)r * C + k0 + c : nullptr;
    });
  };
  auto compute = [&](int buf) {
    const float* gs = ring + buf * SE;
    tc::warp_mma_f32<4, 1, true, true>(acc, gs, LDX, gs + X_EL, LDX, 0, 8 * warp, KB, mt);
  };
  tc::pipeline<BWD_STAGES>((C + KB - 1) / KB, load, compute);
  const int g = lane >> 2, t = lane & 3, col = 8 * warp + 2 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * i + g + 8 * h;
      const bool live = row < L;
      tc::store2f(dos + row * LDH + col, live ? acc[i][0][2 * h] : 0.f,
                  live ? acc[i][0][2 * h + 1] : 0.f);
    }
  }
}

// grid (heads, N), BWD_SMEM bytes. With P the fp32 probabilities:
//   o = P v, dP = dO v^T, dS = P (dP - rowsum(dP P)) scale,
//   dq = dS k, dv = P^T dO, dk = dS^T q
// o to a.o, dq | dk | dv to a.dqkv at this head's columns.
__global__ void __launch_bounds__(THREADS) bwd_core_kernel(HeadArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  float *qs = ring + BWD_RING_EL, *ks = qs + HEAD_EL, *vs = ks + HEAD_EL;
  // in the ring once both projections have drained it
  float *ps = ring, *dss = ps + LMAX * LDP, *dos = dss + LMAX * LDP;
  const int head = blockIdx.x, n = blockIdx.y, mt = (a.L + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int L = a.L, C = a.C;
  const size_t row0 = (size_t)n * L;
  tc::griddep_launch();  // the tail may start streaming the weights
  const wtc::KeyPad pad(a, n);
  float* const qkv[3] = {qs, ks, vs};
  project_qkv<3, BWD_STAGES>(a, n, head, mt, ring, 0, qkv);
  project_dout(a, n, head, mt, ring, dos);  // reuses the drained ring
  __syncthreads();
  const uint64_t padded = pad.bits();
  if (warp < mt) {
    float p[8][4], acc[4][4];
    softmax_rows(p, qs, ks, padded, L, mt, a.scale, warp);
    times_rows(acc, p, vs, mt);
    store_rows(a.o + row0 * C + head * D, C, acc, 16 * warp, L);
    // dP = dO v^T, one partial (d deep), then dS in its place
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      tc::Frag<4> da;
      tc::frag_a_f32(da, dos, LDH, 16 * warp, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * mt) continue;
        tc::Frag<2> vb;
        tc::frag_b_f32<true>(vb, vs, LDH, k0, 8 * j);
        tc::mma3(ds[j], da, vb);
      }
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += ds[j][e] * p[j][e];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], o);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - rs[e >> 1]) * a.scale;
    // P and dS to shared memory for the transposed products (rows >= L zero)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      const bool live = row < L;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * mt) continue;
        tc::store2f(ps + row * LDP + 8 * j + 2 * t, live ? p[j][2 * h] : 0.f,
                    live ? p[j][2 * h + 1] : 0.f);
        tc::store2f(dss + row * LDP + 8 * j + 2 * t, live ? ds[j][2 * h] : 0.f,
                    live ? ds[j][2 * h + 1] : 0.f);
      }
    }
    times_rows(acc, ds, ks, mt);
    store_rows(a.dqkv + row0 * 3 * C + head * D, 3 * C, acc, 16 * warp, L);
  }
  __syncthreads();
  // dv = P^T dO, dk = dS^T q: (product, 16-key tile) units over the
  // warps, each one partial over the 16 mt queries, taken in pairs (A at
  // rows 2t, 2t + 1 of P or dS; B at the same rows of dO or q)
  for (int u = warp; u < 2 * mt; u += THREADS / 32) {
    const int prod = u / mt, m0 = 16 * (u % mt);
    const float* As = prod == 0 ? ps : dss;
    const float* Bs = prod == 0 ? dos : qs;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < 16 * mt; k0 += 8) {
      const float* ap = As + (k0 + 2 * t) * LDP + m0 + g;
      tc::Frag<4> af;
      af.set(0, ap[0]);
      af.set(1, ap[8]);
      af.set(2, ap[LDP]);
      af.set(3, ap[LDP + 8]);
      const float* bp = Bs + (k0 + 2 * t) * LDH + g;
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        tc::Frag<2> bf;
        bf.set(0, bp[8 * jd]);
        bf.set(1, bp[LDH + 8 * jd]);
        tc::mma3(acc[jd], af, bf);
      }
    }
    store_rows(a.dqkv + row0 * 3 * C + (prod == 0 ? 2 * C : C) + head * D, 3 * C, acc, m0, L);
  }
}

// wtc::bwd_tail_kernel with fp32 tiles: n_dx blocks of dx = dq wq^T + dk
// wk^T + dv wv^T in 64 x 64 tiles, k = 3C split dx_splits ways; n_dw
// blocks of the weight gradients z = q, k, v, o: grads_z[:C] = A_z^T B_z,
// grads_z[C] = column sums of B_z, (A, B) = (x, dq | dk | dv) or (o, g),
// over the rows split `splits` ways. Splits meet in split_fixup.
using TailF = tc::GemmF32<64, 64, 2, 2, 2>;
__global__ void __launch_bounds__(THREADS) bwd_tail_kernel(wtc::TailArgsT<float> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  using G = TailF;
  constexpr int TILE = G::BM * G::BN;
  constexpr int BK = tc::BK;
  const int C = a.C, rows = a.rows;
  float acc[G::MI][G::NI][4];
  const int id = blockIdx.x;
  const bool dx = a.dx_first ? id < a.n_dx : id >= a.n_dw;
  if (dx) {
    const int b = a.dx_first ? id : id - a.n_dw;
    const int s = b % a.dx_splits, tile = b / a.dx_splits;
    const int mb = (tile / a.tn) * G::BM, nb = (tile % a.tn) * G::BN;
    const int K = 3 * C, kt = (K + BK - 1) / BK;
    const int kt0 = min(kt, s * a.dx_per), kt1 = min(kt, kt0 + a.dx_per);
    tc::gemm_tile_f32<G, false, true>(
        acc, ring, kt0, kt1,
        [&](int r, int c, int k0) -> const float* {
          return mb + r < rows && k0 + c < K ? a.dqkv + (size_t)(mb + r) * K + k0 + c : nullptr;
        },
        [&](int r, int c, int k0) -> const float* {
          const int k = k0 + c, z = k / C;
          // selects, not a.w[z]: a run-time index would put w in local memory
          const float* w = z == 0 ? a.w[0] : z == 1 ? a.w[1] : a.w[2];
          return nb + r < C && k < K ? w + (size_t)(nb + r) * C + k - z * C : nullptr;
        },
        [](const float*, int) {}, [] { tc::griddep_wait(); });
    if (a.dx_splits > 1) {
      float none[1];
      if (!tc::split_fixup<THREADS, G::MI, G::NI, 0>(acc, none,
                                                     a.dx_part + (size_t)tile * a.dx_splits * TILE,
                                                     a.dx_splits, s, a.counters + a.dw_tiles + tile))
        return;
    }
    tc::for_pairs<G>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
      if (row < rows && col < C) tc::store2f(a.dx + (size_t)row * C + col, v0, v1);
    });
    return;
  }
  const int b = a.dx_first ? id - a.n_dx : id, s = b % a.splits, tile = b / a.splits;
  const int per_z = a.tn * a.tn, z = tile / per_z;
  const int mb = ((tile % per_z) / a.tn) * G::BM, nb = (tile % a.tn) * G::BN;
  const float* A = z < 3 ? a.x : a.o;
  const float* B = z == 0 ? a.dqkv : z == 1 ? a.dqkv + C : z == 2 ? a.dqkv + 2 * C : a.g;
  const int ldb = z < 3 ? 3 * C : C;
  const int kt = (rows + BK - 1) / BK, kt0 = min(kt, s * a.per), kt1 = min(kt, kt0 + a.per);
  // bias gradient: the tiles of the first row block also sum B's columns
  // in fp32; thread t takes column t % 64 over half the k-tile's rows
  const bool bias = mb == 0;
  float cs[2] = {0.f, 0.f};
  // B (dq | dk | dv, or g) and o come from the core kernel: x streams in
  // before the wait, o after it
  if (z == 3) tc::griddep_wait();
  tc::gemm_tile_f32<G, true, false, true>(
      acc, ring, kt0, kt1,
      [&](int r, int c, int k0) -> const float* {
        return k0 + r < rows && mb + c < C ? A + (size_t)(k0 + r) * C + mb + c : nullptr;
      },
      [&](int r, int c, int k0) -> const float* {
        return k0 + r < rows && nb + c < C ? B + (size_t)(k0 + r) * ldb + nb + c : nullptr;
      },
      [&](const float* bs, int ld) {
        if (!bias) return;
        const int col = threadIdx.x % G::BN, r0 = (threadIdx.x / G::BN) * (BK / 2);
#pragma unroll 8
        for (int r = 0; r < BK / 2; ++r) cs[0] += bs[(r0 + r) * ld + col];
      },
      [] { tc::griddep_wait(); });
  if (a.splits > 1 &&
      !tc::split_fixup<THREADS, G::MI, G::NI, 1>(
          acc, cs, a.part + (size_t)tile * a.splits * (TILE + THREADS), a.splits, s,
          a.counters + tile))
    return;
  float* out = a.grads + (size_t)z * (C + 1) * C;
  tc::for_pairs<G>(acc, mb, nb, [&](int row, int col, float v0, float v1) {
    if (row < C && col < C) tc::store2f(out + (size_t)row * C + col, v0, v1);
  });
  if (bias) {
    __shared__ float half[G::BN];
    if (threadIdx.x >= G::BN) half[threadIdx.x - G::BN] = cs[0];
    __syncthreads();
    if (threadIdx.x < G::BN && nb + threadIdx.x < C)
      out[(size_t)C * C + nb + threadIdx.x] = cs[0] + half[threadIdx.x];
  }
}

constexpr size_t kTailSmem = TailF::smem<true, false>() > TailF::smem<false, true>()
                                 ? TailF::smem<true, false>() : TailF::smem<false, true>();

inline int backward(const void* x, const uint8_t* mask, const void* g, const void* wq,
                    const void* bq, const void* wk, const void* bk, const void* wv,
                    const void* bv, const void* wo, int N, int L, int C, int heads, void* dx,
                    void* o, void* dqkv, float* grads, float* scratch, int* counters,
                    cudaStream_t st) {
  if (!wtc::takes(L, C / heads) || C % heads) return (int)cudaErrorInvalidValue;
  HeadArgs h = head_args(x, mask, wq, bq, wk, bk, wv, bv, wo, g, L, C, heads);
  h.o = (float*)o;
  h.dqkv = (float*)dqkv;
  h.cs = 1;
  cudaError_t e =
      tc::launch(bwd_core_kernel, dim3(heads, N), BWD_SMEM, st, wtc::cluster_of(1), h);
  if (e != cudaSuccess) return (int)e;
  const wtc::TailPlan p = wtc::tail_plan(N * L, C);
  if (!wtc::tail_counters_fit(p)) return (int)cudaErrorInvalidValue;
  const auto ta = wtc::tail_args<float>(p, x, g, o, dqkv, wq, wk, wv, dx, grads, N * L, C,
                                        scratch, counters);
  e = tc::launch(bwd_tail_kernel, dim3(p.n_dw + p.n_dx), kTailSmem, st, tc::after_previous(), ta);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace wtf

}  // namespace ldm

// The routes of a call, by dtype and shape alone. At head dim 32 and L
// <= 64 (every shape of the UNet) both directions run on the tensor cores
// in bfloat16 and in float32 (three TF32 passes). Other shapes take the
// FMA tiles.
static bool on_tensor_cores(int dtype, int L, int C, int heads) {
  return (dtype == 0 || dtype == 1) && heads > 0 && C % heads == 0 &&
         ldm::wtc::takes(L, C / heads);
}

extern "C" int window_mha_tensor_cores(int dtype, int L, int C, int heads) {
  return on_tensor_cores(dtype, L, C, heads);
}

extern "C" int window_mha_bwd_tensor_cores(int dtype, int L, int C, int heads) {
  return on_tensor_cores(dtype, L, C, heads);
}

extern "C" int window_mha_forward(int dtype, const void* x, const void* mask, const void* wq,
                                  const void* bq, const void* wk, const void* bk,
                                  const void* wv, const void* bv, const void* wo,
                                  const void* bo, int N, int L, int C, int heads, void* qkv,
                                  void* o, void* out, void* scratch, void* counters,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (on_tensor_cores(dtype, L, C, heads))
    return dtype == 0 ? ldm::wtf::forward(x, m, wq, bq, wk, bk, wv, bv, wo, bo, N, L, C, heads,
                                          o, out, (float*)scratch, (int*)counters, st)
                      : ldm::wtc::forward(x, m, wq, bq, wk, bk, wv, bv, wo, bo, N, L, C, heads,
                                          o, out, (float*)scratch, (int*)counters, st);
  if (dtype == 0)
    return ldm::window_mha<float>(x, m, wq, bq, wk, bk, wv, bv, wo, bo, N, L, C, heads, qkv, o,
                                  out, (float*)scratch, st);
  if (dtype == 1)
    return ldm::window_mha<__nv_bfloat16>(x, m, wq, bq, wk, bk, wv, bv, wo, bo, N, L, C, heads,
                                          qkv, o, out, (float*)scratch, st);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one attention block needs, for the wrapper's check.
extern "C" long long window_mha_smem_bytes(int dtype, int L, int C, int heads) {
  if (on_tensor_cores(dtype, L, C, heads))
    return (long long)(dtype == 0 ? ldm::wtf::FWD_SMEM_CLUSTER : ldm::wtc::FWD_SMEM_CLUSTER);
  return (long long)ldm::attn_smem_bytes(L, C / heads);
}

// fp32 scratch (split partial sums) one call needs, for the wrapper.
extern "C" long long window_mha_scratch_floats(int dtype, int N, int L, int C, int heads) {
  if (on_tensor_cores(dtype, L, C, heads)) return (long long)ldm::wtc::out_plan(N * L, C).floats;
  const size_t a = ldm::proj_plan(N * L, C, C, 3).floats;
  const size_t b = ldm::proj_plan(N * L, C, C, 1).floats;
  return (long long)(a > b ? a : b);
}

// int32 split counters the tensor-core route needs zeroed before its
// first call; every call leaves them zero.
extern "C" long long window_mha_counter_ints() { return ldm::wtc::kCounters; }

extern "C" int window_mha_backward(int dtype, const void* x, const void* mask, const void* g,
                                   const void* wq, const void* bq, const void* wk,
                                   const void* bk, const void* wv, const void* bv,
                                   const void* wo, int N, int L, int C, int heads, void* dx,
                                   void* qkv, void* o, void* dout, void* dqkv, void* grads,
                                   void* scratch, void* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (on_tensor_cores(dtype, L, C, heads))
    return dtype == 0 ? ldm::wtf::backward(x, m, g, wq, bq, wk, bk, wv, bv, wo, N, L, C, heads,
                                           dx, o, dqkv, (float*)grads, (float*)scratch,
                                           (int*)counters, st)
                      : ldm::wtc::backward(x, m, g, wq, bq, wk, bk, wv, bv, wo, N, L, C, heads,
                                           dx, o, dqkv, (float*)grads, (float*)scratch,
                                           (int*)counters, st);
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
extern "C" long long window_mha_bwd_smem_bytes(int dtype, int L, int C, int heads) {
  if (on_tensor_cores(dtype, L, C, heads))
    return (long long)(dtype == 0 ? ldm::wtf::BWD_SMEM : ldm::wtc::BWD_SMEM);
  return (long long)ldm::attn_bwd_smem_bytes(L, C / heads);
}

// fp32 scratch (split partial sums) one backward call needs.
extern "C" long long window_mha_bwd_scratch_floats(int dtype, int N, int L, int C, int heads) {
  if (on_tensor_cores(dtype, L, C, heads)) return (long long)ldm::wtc::tail_plan(N * L, C).floats;
  return (long long)ldm::attn_bwd_scratch_floats(N, L, C);
}
