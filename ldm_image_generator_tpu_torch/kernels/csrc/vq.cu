// Nearest-codebook search of the VectorQuantizer on the H100's tensor
// cores: for each of N vectors x[N, 8] (float32 or bfloat16) the int32
// argmin over the K rows of the float32 codebook e[K, 8] of
//   score = ||e_k||^2 - 2 x . e_k
// with the first index on ties. The Hopper counterpart of
// nearest_codebook_indices_pallas (ldm_image_generator_tpu/kernels/vq.py:56,
// body _vq_kernel), which kept the whole codebook and a [512, K] score
// tile in VMEM and reduced it with a min and a masked min of the column.
//
// Bound: N * K pairs, each a D = 8 dot, a score and a compare, on a few
// hundred KB, so operations. An fp32-accurate dot is done at the least
// cost as TF32 tensor-core passes: three for an fp32 x (big*big,
// big*small, small*big), two for a bf16 x, exact in TF32; the compare
// runs on the CUDA cores. Design:
//   - The dot runs on mma.sync m16n8k8 TF32, whose k is exactly D: A is
//     16 rows of x, B is 8 codes of -2e, and the accumulator starts at
//     ||e||^2 (rounded once from a float64 sum), so the score leaves the
//     tensor cores whole. Each operand is split as hi = tf32(v), lo =
//     tf32(v - hi); score = C + hi.hi, then + hi.lo and + lo.hi (a
//     bfloat16 x is exactly a TF32 value: two passes). The dropped lo.lo
//     and the tensor cores' truncating accumulation leave each score
//     within a few 2**-23 of its terms' magnitude, inside
//     workloads.VQ_TIE_REL.
//   - The CUDA cores only compare, and every (row, code) score passes
//     through the integer pipe, where min, compare and select run at half
//     the FP32 pipe's lanes. Each thread holds two rows of each m-tile
//     against two codes (2t, 2t + 1) of each 8-code tile; per row it
//     takes the pair's minimum, and on a strict < against its
//     running minimum keeps it with the pair's code, the odd one found on
//     the FP32 pipe (see the main loop). Codes go in increasing order, so
//     each thread keeps its first index; the quad's four lanes and every
//     later merge break equal scores toward the lower index.
//   - One launch, no partials in device memory: a thread-block cluster of
//     up to 8 CTAs splits K; each CTA stages its slice of the codebook,
//     split into hi/lo as it loads (consecutive threads write consecutive
//     16-byte records, free of bank conflicts), in shared memory, 72 bytes
//     a code. A CTA's 8 warps take 32 rows each against one half of the
//     slice; the halves meet in shared memory, each rank writes its rows'
//     (min, index) into its own slot of rank 0's shared memory (distributed
//     shared memory), and after one cluster.sync() rank 0 merges the slots
//     in rank order. No atomics: reruns are bitwise equal.
//   - Ragged edges: rows past N read x = 0 and are never stored; codes
//     past a slice's end get ||e||^2 = +inf and B = 0, so they score +inf
//     and never win a strict <.
//
// VQ_DROP (0 unless defined; cli/vq_breakdown.py builds the others) takes
// parts of the main loop out, to show where a call's time goes: bit 0
// puts a stand-in of one integer operation per score in place of the
// products, bit 1 a running fminf in place of the compare, bit 2 skips
// the loop (launch, staging and merges). Such a build's indices are wrong.
#include <cooperative_groups.h>
#include <math_constants.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#ifndef VQ_DROP
#define VQ_DROP 0
#endif

#include "mma_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int D = 8;
constexpr int ROW_WARPS = 4;   // warps along the rows, 16 * MT rows each
constexpr int HALVES = 2;      // warps along the slice's codes
constexpr int THREADS = 32 * ROW_WARPS * HALVES;
constexpr int MT = 2;          // 16-row m-tiles per warp
constexpr int ROWS = ROW_WARPS * 16 * MT;
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int CHUNK = 1536;     // codes staged in shared memory at a time
// shared memory per staged code: hi/lo of -2e as four float4 (one per
// lane of a quad) and ||e||^2 twice (an accumulator quad per lane)
constexpr int CODE_BYTES = 4 * 16 + 8;
// 16-byte records (4 a code) each thread stages per chunk
constexpr int REC_PER_THREAD = 4 * CHUNK / THREADS;
static_assert(REC_PER_THREAD * THREADS == 4 * CHUNK && THREADS % 32 == 0,
              "a chunk is staged in one pass of whole warps");

struct Args {
  const void* x;
  const float* e;
  int n, k;
  int slice;  // codes per cluster rank (a multiple of 8)
  int chunk;  // codes staged at a time (a multiple of 8)
  int* out;
};

// v rounded to TF32 (10 mantissa bits), ties away from zero, as
// cvt.rna.tf32.f32 gives, in two integer operations (the conversion unit
// runs at a quarter of their rate).
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// d = a (16 x 8, row) * b (8 x 8, col) + c, TF32 in, fp32 accumulate.
// Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4): a0 (g,
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t +
// 4, g); c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, the same columns).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, float c0, float c1, float c2, float c3) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c0), "f"(c1),
        "f"(c2), "f"(c3));
}

// (s, i) replaces (best, idx) when its score is lower, or equal with a
// lower index.
__device__ __forceinline__ void take_min(float& best, int& idx, float s, int i) {
  if (s < best || (s == best && i < idx)) {
    best = s;
    idx = i;
  }
}

// Stage codes [c0, c0 + tiles * 8) of e into rec and qs: record 4 j + t
// = (hi(-2e_t), hi(-2e_{t+4}), lo(-2e_t), lo(-2e_{t+4})) of code j, lane
// t's B fragments; qs[4 (j / 2) + {0, 2} + j % 2] = ||e_j||^2, so that
// lane t of tile jt reads its accumulator quad (q_2t, q_2t+1, q_2t,
// q_2t+1) at qs + 16 jt + 4 t. Codes at or past c_end: zeros and +inf.
// Thread r of a pass stages record r: the four lanes of a quad hold one
// code between them and sum its squares (float64, exact products) by
// shuffles. Every load is issued before the first is used.
__device__ __forceinline__ void stage(const float* __restrict__ e, int c0, int c_end, int tiles,
                                      float4* rec, float* qs) {
  float v[REC_PER_THREAD][2];
#pragma unroll
  for (int u = 0; u < REC_PER_THREAD; ++u) {
    const int r = threadIdx.x + u * THREADS, c = c0 + (r >> 2), t = r & 3;
    v[u][0] = v[u][1] = 0.0f;
    if (r < tiles * 32 && c < c_end) {
      v[u][0] = __ldg(e + (size_t)c * D + t);
      v[u][1] = __ldg(e + (size_t)c * D + t + 4);
    }
  }
#pragma unroll
  for (int u = 0; u < REC_PER_THREAD; ++u) {
    const int r = threadIdx.x + u * THREADS, j = r >> 2;
    if (u * THREADS >= tiles * 32) break;  // the whole block is past the chunk
    double s = fma((double)v[u][0], (double)v[u][0], (double)v[u][1] * (double)v[u][1]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (r < tiles * 32) {
      const float m0 = -2.0f * v[u][0], m1 = -2.0f * v[u][1];  // exact
      const float h0 = __uint_as_float(tf32(m0)), h1 = __uint_as_float(tf32(m1));
      rec[r] = make_float4(h0, h1, __uint_as_float(tf32(m0 - h0)), __uint_as_float(tf32(m1 - h1)));
      if ((r & 3) < 2)
        qs[4 * (j >> 1) + (j & 1) + 2 * (r & 1)] = c0 + j < c_end ? __double2float_rn(s) : CUDART_INF_F;
    }
  }
}

// grid (cluster size, row blocks) in clusters of (cluster size, 1, 1);
// THREADS threads, two CTAs to an SM (at most 128 registers a thread);
// dynamic shared memory smem_bytes(chunk).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2) vq_kernel(Args a) {
  constexpr bool SPLIT_X = std::is_same<T, float>::value;  // bf16 is exact in TF32
  extern __shared__ float4 smem[];
  float4* rec = smem;                                         // [chunk][4]
  float* qs = reinterpret_cast<float*>(smem + 4 * a.chunk);   // [2 chunk]
  float* half_best = qs + 2 * a.chunk;                        // [HALVES][ROWS]
  int* half_idx = reinterpret_cast<int*>(half_best + HALVES * ROWS);
  float* rank_best = reinterpret_cast<float*>(half_idx + HALVES * ROWS);  // [MAX_CLUSTER][ROWS]
  int* rank_idx = reinterpret_cast<int*>(rank_best + MAX_CLUSTER * ROWS);

  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), ranks = (int)cl.num_blocks();
  // this CTA has started: its shared memory may be written by the others
  // once they have waited on this arrival (before the push below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int half = warp / ROW_WARPS, wrow = (warp % ROW_WARPS) * 16 * MT;
  const int k_begin = rank * a.slice;
  const int k_end = min(a.k, k_begin + a.slice);
  const T* x = static_cast<const T*>(a.x);

  uint32_t ahi[MT][4], alo[MT][4];
  float best[MT][2];
  float idx[MT][2];  // code indices, exact in fp32 (k <= 2**24)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = blockIdx.y * ROWS + wrow + 16 * i + g + 8 * (f & 1), d = t + 4 * (f >> 1);
      const float v = r < a.n ? ldm::to_f(x[(size_t)r * D + d]) : 0.0f;
      ahi[i][f] = tf32(v);
      alo[i][f] = SPLIT_X ? tf32(v - __uint_as_float(ahi[i][f])) : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[i][h] = CUDART_INF_F;
      idx[i][h] = (float)k_begin;
    }
  }

  for (int c0 = k_begin; c0 < k_end; c0 += a.chunk) {
    const int tiles = (min(a.chunk, k_end - c0) + 7) >> 3;
    __syncthreads();  // the previous chunk is no longer read
    stage(a.e, c0, k_end, tiles, rec, qs);
    __syncthreads();
    const int mid = (tiles + 1) >> 1, jt1 = half ? tiles : mid;
    int jt = half ? mid : 0;
    float code = (float)(c0 + 8 * jt + 2 * t);  // this lane's even code of tile jt
#pragma unroll 8
    for (; jt < ((VQ_DROP & 4) ? jt : jt1); ++jt, code += 8.0f) {
      const float4 b = rec[4 * (8 * jt + g) + t];
      const float4 q = *reinterpret_cast<const float4*>(qs + 16 * jt + 4 * t);
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float s[4];
#if VQ_DROP & 1
        s[0] = q.x + __uint_as_float(ahi[i][0] ^ bh0);
        s[1] = q.y + __uint_as_float(ahi[i][1] ^ bl0);
        s[2] = q.z + __uint_as_float(ahi[i][2] ^ bh1);
        s[3] = q.w + __uint_as_float(alo[i][3] ^ bl1);
#else
        mma_tf32(s, ahi[i], bh0, bh1, q.x, q.y, q.z, q.w);
        mma_tf32(s, ahi[i], bl0, bl1, s[0], s[1], s[2], s[3]);
        if (SPLIT_X) mma_tf32(s, alo[i], bh0, bh1, s[0], s[1], s[2], s[3]);
#endif
#if VQ_DROP & 2
        best[i][0] = fminf(best[i][0], fminf(s[0], s[1]));
        best[i][1] = fminf(best[i][1], fminf(s[2], s[3]));
#else
        // Each row's pair (code, code + 1): its minimum replaces the row's
        // on a strict <. Which code of the pair runs on the FP32 pipe:
        // (s0 - m) scaled past 1 and saturated is 0 when the even code is
        // the minimum (or ties it), 1 otherwise; the integer pipe does a
        // min, a compare and two selects per pair.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float s0 = s[2 * h], m = fminf(s0, s[2 * h + 1]);
          const float odd = __saturatef((s0 - m) * 0x1p126f * 0x1p126f);
          if (m < best[i][h]) {
            best[i][h] = m;
            idx[i][h] = code + odd;
          }
        }
#endif
      }
    }
  }

  // the quad's four lanes hold one row's codes between them; then the
  // slice's two halves meet in shared memory
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int id = (int)idx[i][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        take_min(best[i][h], id, __shfl_xor_sync(0xffffffffu, best[i][h], o),
                 __shfl_xor_sync(0xffffffffu, id, o));
      if (t == 0) {
        const int r = half * ROWS + wrow + 16 * i + 8 * h + g;
        half_best[r] = best[i][h];
        half_idx[r] = id;
      }
    }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // rank 0 has started
  // each CTA's rows go into rank 0's shared memory, slot `rank`
  if (threadIdx.x < ROWS) {
    float b = half_best[threadIdx.x];
    int bi = half_idx[threadIdx.x];
    for (int hh = 1; hh < HALVES; ++hh)
      take_min(b, bi, half_best[hh * ROWS + threadIdx.x], half_idx[hh * ROWS + threadIdx.x]);
    cl.map_shared_rank(rank_best, 0)[rank * ROWS + threadIdx.x] = b;
    cl.map_shared_rank(rank_idx, 0)[rank * ROWS + threadIdx.x] = bi;
  }
  cl.sync();  // every rank's rows are in rank 0's shared memory
  const int row = blockIdx.y * ROWS + threadIdx.x;
  if (rank == 0 && threadIdx.x < ROWS && row < a.n) {
    float b = rank_best[threadIdx.x];
    int bi = rank_idx[threadIdx.x];
    for (int r = 1; r < ranks; ++r)
      take_min(b, bi, rank_best[r * ROWS + threadIdx.x], rank_idx[r * ROWS + threadIdx.x]);
    a.out[row] = bi;
  }
}

inline size_t smem_bytes(int chunk) {
  return (size_t)chunk * CODE_BYTES + (HALVES + MAX_CLUSTER) * ROWS * 8;
}

inline cudaLaunchConfig_t config(int ranks, int row_blocks, int chunk, cudaStream_t st,
                                 cudaLaunchAttribute* at) {
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = ranks;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, row_blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(chunk);
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of cs CTAs with `chunk` codes staged that the current device
// holds at once (0 when none fits or the runtime refuses the shape),
// asked of the runtime once per (device, cs, chunk) it answers.
inline int active_clusters(int cs, int chunk) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> seen;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_tuple(dev, cs, chunk);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  int clusters = 0;
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = config(cs, 1, chunk, nullptr, &at);
  if (ldm::allow_smem(vq_kernel<float>, cfg.dynamicSmemBytes) != cudaSuccess ||
      ldm::allow_smem(vq_kernel<__nv_bfloat16>, cfg.dynamicSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, vq_kernel<float>, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a shape the card refuses is not an error of the call
    return 0;
  }
  seen[key] = clusters;
  return clusters;
}

// How a call is cut: ROWS rows per CTA; K split over a cluster of cs <=
// MAX_CLUSTER CTAs, each rank's slice a multiple of 8 codes and none
// empty. An SM runs its CTAs side by side, so a call takes about (waves
// of clusters) x (CTAs on the busiest SM) CTA-times, a CTA's time 1 / cs
// of its rows' work: cs minimises that (the larger cs on a tie). N =
// 4608, K = 8192 on the H100: 36 row blocks, cs = 6 (39 clusters fit),
// 216 CTAs, at most two on an SM.
struct Plan {
  int ranks, slice, chunk, row_blocks;
};

inline Plan cut(int row_blocks, int k, int cs) {
  Plan p;
  p.row_blocks = row_blocks;
  p.slice = ((k + cs - 1) / cs + 7) & ~7;
  p.ranks = (k + p.slice - 1) / p.slice;
  p.chunk = std::min(p.slice, CHUNK);
  return p;
}

inline Plan plan(int n, int k) {
  const int rb = (n + ROWS - 1) / ROWS, sms = ldm::tc::sm_count();
  Plan best = cut(rb, k, 1);
  long best_t = -1;
  for (int cs = 1; cs <= MAX_CLUSTER; ++cs) {
    const Plan p = cut(rb, k, cs);
    if (p.ranks != cs) continue;
    const int fit = active_clusters(p.ranks, p.chunk);
    if (fit <= 0) continue;
    const long waves = (rb + fit - 1) / fit;
    const long busiest = ((long)std::min(rb, fit) * p.ranks + sms - 1) / sms;
    const long t = waves * busiest;  // CTA-times of 1 / ranks each
    if (best_t < 0 || t * best.ranks <= best_t * p.ranks) {
      best = p;
      best_t = t;
    }
  }
  return best;
}

}  // namespace

// Codes per cluster rank for n rows and k codes (rank r takes codes
// [r * slice, (r + 1) * slice)); the card tests place duplicates by it.
extern "C" int vq_slice_codes(int n, int k) { return n > 0 && k > 0 ? plan(n, k).slice : 0; }

// out[n] = argmin_k (||e_k||^2 - 2 x_n . e_k), first index on ties, in
// one launch. dtype of x: 0 = float32, 1 = bfloat16; e is float32 [k, 8],
// 16-byte aligned; k <= 2**24.
extern "C" int vq_nearest(int dtype, const void* x, const void* e, int n, int k, void* out,
                          void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || k > (1 << 24) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, k);
  if (p.row_blocks > 65535) return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(e), n, k, p.slice, p.chunk, static_cast<int*>(out)};
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg =
      config(p.ranks, p.row_blocks, p.chunk, static_cast<cudaStream_t>(stream), &at);
  cudaError_t err = dtype == 0 ? ldm::allow_smem(vq_kernel<float>, cfg.dynamicSmemBytes)
                               : ldm::allow_smem(vq_kernel<__nv_bfloat16>, cfg.dynamicSmemBytes);
  if (err == cudaSuccess)
    err = dtype == 0 ? cudaLaunchKernelEx(&cfg, vq_kernel<float>, a)
                     : cudaLaunchKernelEx(&cfg, vq_kernel<__nv_bfloat16>, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
