// The bf16 forward of ffn_block on Hopper's wgmma, for the row counts
// where its products have thousands of rows (served buckets and batched
// sampling; the route's rule is ffn_wgmma_route in ffn_block.cu). Launches
// as ffn_tc_fwd.cuh's forward does: norm_film_rows_kernel, then the gate
// (gate_kernel<WgGate<256>>) and the output product over the three towers
// with the biases in its epilogue (out_kernel<WgOut<128>, false>), the two
// as programmatic dependent launches that stream their first weight tiles
// before griddepcontrol.wait. Same maths and rounding points: a, b and out
// in fp32, g and out rounded once to bf16; only the k sum's order differs.
//
// What bounds a call on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the 18 N C M
// FLOP at C >= 256 (a B=256 call at 256px: 78 us), the bytes of x, h, g
// and out at C = 128. The mma.sync kernels reached a tenth of either at
// these shapes (four-warp 64-row blocks, fragments by ldmatrix). Here a
// block is two consumer warpgroups of 64 rows (wgmma.mma_async m64nBNk16,
// fp32 accumulators in registers, 128 a thread at BN = 256) and one
// producer warp that keeps a ring of 64-deep k-tiles in flight by TMA,
// 128-byte swizzled so each 64 x 64 box lands in wgmma's canonical layout:
// A (h or g) K-major, B the weights as they lie ([C, M]: rows along k,
// MN-major, wgmma's transpose bit), the expert slices chosen by the
// producer from the device-resident ids as the third coordinate of the
// stacked weights' 3-D maps. Stages complete on mbarriers (full: the TMA's
// bytes; empty: the eight consumer warps). Blocks are persistent, one an
// SM, and walk the work units in order (rows slowest), so the units in
// flight share their h or g rows in L2 and the producer loads the next
// unit while the consumers store. The epilogues go through shared memory
// (swizzled 64 x 64 boxes, TMA stores that clip the rows past N). The
// output's k is split only where its tiles do not fill the card (the last
// unit of a tile to arrive sums the fp32 partials in split order), so
// reruns are bitwise equal. On the card (PERF.md) the C >= 256 calls reach 40-55% of
// the FLOP bound, each k-tile of a block streaming 48 KB (gate) or 32 KB
// (output) from L2; the C = 128 calls, 2-6 k-tiles a unit, about 60% of
// device-memory bandwidth, a unit's epilogue running after its products.
#pragma once

#include <cuda.h>

#include <algorithm>

#include "ffn_tc_fwd.cuh"

namespace ldm {
namespace ftc {

// The tiles of the wgmma route, named in the kernels' template arguments:
// 128 rows by BN wgmma columns. The gate's BN columns are BN / 2 hidden
// columns of a, then of b, in 64-column boxes [a | b | a | b]; the output
// tile's are BN output columns.
template <int BN_>
struct WgGate {
  static constexpr int BN = BN_, OUT_COLS = BN_ / 2;
  static constexpr bool GATE = true;
};
template <int BN_>
struct WgOut {
  static constexpr int BN = BN_, OUT_COLS = BN_;
  static constexpr bool GATE = false;
};

namespace wg {

static_assert(sizeof(TmaMap) == sizeof(CUtensorMap) && alignof(TmaMap) == alignof(CUtensorMap),
              "TmaMap stands for CUtensorMap");

constexpr int kRows = 128;                   // rows of a tile: two warpgroups of 64
constexpr int kConsumers = 256;              // the consumer warpgroups' threads
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kBox = 64 * 64 * 2;            // bytes of one 64 x 64 bf16 box
constexpr size_t kSmemMax = 232448;          // dynamic shared memory a block may have

// Shared memory of a block: the ring of STAGES k-tiles (A: two 64-row
// boxes; B: BN / 64 boxes), the staging tile of the epilogue (64 rows by
// OUT_COLS for each warpgroup), the mbarriers and the split flag, after
// up to 1 KB of padding to the swizzle's 1024-byte alignment.
template <class G>
struct Layout {
  static constexpr int A_BYTES = 2 * kBox, B_BYTES = G::BN / 64 * kBox;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGING = 2 * 64 * G::OUT_COLS * 2;
  static constexpr int EXTRA = 1024 + 256;
  static constexpr int FIT = (int)((kSmemMax - EXTRA - STAGING) / STAGE);
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr size_t smem = EXTRA + STAGING + (size_t)STAGES * STAGE;
  static constexpr int NQ = G::BN / 8;                 // n8 blocks of an accumulator
  static constexpr int PART = NQ * 4 * kConsumers;     // fp32 of a split partial
  static_assert(STAGES >= 3 && smem <= kSmemMax, "a ring of at least 3 k-tiles");
};

// wgmma m64nNk16, bf16 x bf16 -> fp32, A and B from shared memory
// (descriptors), A K-major, B MN-major (transposed); d += A B, or d = A B
// where scale_d is 0.
template <int N>
struct Mma;
template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(float (&d)[32][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[16][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (K-major A: the 8-row groups
// 1024 bytes apart, the leading offset unused; MN-major B: the 64-column
// boxes kBox apart, the 8-row k groups 1024 apart).
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of the accumulators above a wait.
template <int NQ>
__device__ __forceinline__ void fence_acc(float (&d)[NQ][4]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[q][e])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = tc::smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: a box of map at the coordinates (innermost first) into shared
// memory, completing on bar; a box from shared memory to the map's tensor
// (rows past its extent are not written).
__device__ __forceinline__ void tma_load(void* dst, const TmaMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const TmaMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(tc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store(const TmaMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(tc::smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store(const TmaMap* map, const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(tc::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores have read their shared memory / are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// shared-memory writes of this thread visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One work unit: the tile's 128-row block rt, its first column (hidden
// column of the gate's tower, or output column), the tower (gate), the
// split s and its k-tiles [kt0, kt1), the tile's index (split partials,
// counters).
struct Unit {
  int rt, col, tower, s, kt0, kt1, tile;
};

// Units are ordered (row block, [tower,] column tile, split), splits
// fastest: the blocks in flight work on neighbouring rows.
template <class G>
__device__ __forceinline__ Unit unit_of(int u, const Split& sp, int cols, int ktiles) {
  constexpr int W = G::GATE ? G::BN / 2 : G::BN;
  Unit x;
  x.s = u % sp.splits;
  x.tile = u / sp.splits;
  const int per_row = (G::GATE ? 3 : 1) * cols, c = x.tile % per_row;
  x.rt = x.tile / per_row;
  x.tower = G::GATE ? c / cols : 0;
  x.col = (c % cols) * W;
  x.kt0 = x.s * sp.per;
  x.kt1 = min(ktiles, x.kt0 + sp.per);
  return x;
}

// Deterministic split-K fix-up for the consumer threads (tc::split_fixup's
// scheme: partials written in this thread's register order, the last unit
// of the tile to arrive sums them in split order and resets the counter).
template <int NQ>
__device__ __forceinline__ bool fixup(float (&acc)[NQ][4], float* part, int splits, int s,
                                      int* counter, int* last) {
  constexpr int PER = NQ * 4 * kConsumers;
  const int t = threadIdx.x;
  float* mine = part + (size_t)s * PER + t;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(q * 4 + e) * kConsumers] = acc[q][e];
  __threadfence();
  named_sync(1, kConsumers);
  if (t == 0) *last = atomicAdd(counter, 1) == splits - 1;
  named_sync(1, kConsumers);
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float* src = part + (size_t)p * PER + t;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] += __ldcg(src + (q * 4 + e) * kConsumers);
  }
  if (t == 0) *counter = 0;
  return true;
}

__device__ __forceinline__ float2 bias2(const bf16* b, int col) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(b + col);
  return make_float2(__low2float(v), __high2float(v));
}

// The body of both kernels (G::GATE: the gate, else the output product).
template <class G>
__device__ __forceinline__ void run(const FwdArgs& a) {
  using L = Layout<G>;
  constexpr int NQ = L::NQ, STAGES = L::STAGES;
  constexpr bool GATE = G::GATE;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* base = wg_smem + ((1024 - (tc::smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* ring = base;
  unsigned char* staging = base + STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + L::STAGING);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);

  const FfnArgs& f = a.f;
  const int N = f.N, C = f.C, M = f.M;
  const Split sp = GATE ? a.gate : a.out;
  const int ktiles = GATE ? C / BK : 3 * M / BK;
  const int cols = GATE ? M / (G::BN / 2) : C / G::BN;
  const int units = (N + kRows - 1) / kRows * (GATE ? 3 : 1) * cols * sp.splits;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the routed experts (inputs: read before the wait)
  const int e1 = f.ids[0], e2 = f.ids[1];
  if (e1 < 0 || e1 >= f.E || e2 < 0 || e2 >= f.E) __trap();  // as expert_slice

  tc::griddep_launch();  // the next kernel may start streaming its weights
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: one thread issues every copy
    if (lane != 0) return;
    const WgMaps& tm = a.tma;
    // B: the gate's [a | b] boxes of hidden columns x.col.. (tower 0 the
    // general ReGLU's [C, M] maps, else the routed expert's slice of the
    // stacked ones); the output's wc boxes of the k-tile's tower
    const auto load_b = [&](int stage, const Unit& x, int k) {
      unsigned char* b = ring + stage * L::STAGE + L::A_BYTES;
#pragma unroll
      for (int j = 0; j < G::BN / 64; ++j) {
        if constexpr (GATE) {
          const int col = x.col + 64 * (j >> 1);
          if (x.tower == 0)
            tma_load(b + j * kBox, (j & 1) ? &tm.gwb : &tm.gwa, &full[stage], col, k * BK);
          else
            tma_load(b + j * kBox, (j & 1) ? &tm.wb : &tm.wa, &full[stage], col, k * BK,
                     x.tower == 1 ? e1 : e2);
        } else {
          const int t = k * BK / M, k0 = k * BK - t * M;
          if (t == 0)
            tma_load(b + j * kBox, &tm.gwc, &full[stage], x.col + 64 * j, k0);
          else
            tma_load(b + j * kBox, &tm.wc, &full[stage], x.col + 64 * j, k0, t == 1 ? e1 : e2);
        }
      }
    };
    // A: the tile's two 64-row boxes of h (gate) or of the k-tile's tower of g
    const auto load_a = [&](int stage, const Unit& x, int k) {
      unsigned char* s = ring + stage * L::STAGE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = x.rt * kRows + 64 * h;
        if constexpr (GATE) {
          tma_load(s + h * kBox, &tm.h, &full[stage], k * BK, row);
        } else {
          const int t = k * BK / M;
          tma_load(s + h * kBox, &tm.g, &full[stage], k * BK - t * M, row, t);
        }
      }
    };
    int it = 0;
    bool first = true;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit x = unit_of<G>(u, sp, cols, ktiles);
      int k = x.kt0;
      if (first) {
        // the first unit's weight tiles stream while the kernel before
        // this one (which writes h or g) finishes
        const int pre = min(STAGES, x.kt1 - x.kt0);
        for (int i = 0; i < pre; ++i) {
          mbar_expect_tx(&full[i], L::STAGE);
          load_b(i, x, x.kt0 + i);
        }
        tc::griddep_wait();
        for (int i = 0; i < pre; ++i) load_a(i, x, x.kt0 + i);
        k += pre;
        it += pre;
        first = false;
      }
      for (; k < x.kt1; ++k, ++it) {
        const int stage = it % STAGES;
        mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[stage], L::STAGE);
        load_b(stage, x, k);
        load_a(stage, x, k);
      }
    }
    return;
  }

  // the consumers: warpgroup wgi holds rows 64 wgi.. of each tile
  const int wgi = warp / 4, tl = tid % 128, wq = tl / 32, g8 = lane / 4, t4 = lane % 4;
  unsigned char* st = staging + wgi * (L::STAGING / 2);
  // the biases: the gate's a and b of each tower, the output's three rows
  const bf16 *ba[3], *bb[3], *bc[3];
  if constexpr (GATE) {
    ba[0] = (const bf16*)f.gba;
    bb[0] = (const bf16*)f.gbb;
    ba[1] = (const bf16*)f.ba + (size_t)e1 * M;
    bb[1] = (const bf16*)f.bb + (size_t)e1 * M;
    ba[2] = (const bf16*)f.ba + (size_t)e2 * M;
    bb[2] = (const bf16*)f.bb + (size_t)e2 * M;
  } else {
    bc[0] = (const bf16*)f.gbc;
    bc[1] = (const bf16*)f.bc + (size_t)e1 * C;
    bc[2] = (const bf16*)f.bc + (size_t)e2 * C;
  }
  float acc[NQ][4];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit x = unit_of<G>(u, sp, cols, ktiles);
    const int nk = x.kt1 - x.kt0;
    int prev = 0;
    for (int k = 0; k < nk; ++k, ++it) {
      const int stage = it % STAGES;
      mbar_wait(&full[stage], (it / STAGES) & 1);
      __syncwarp();  // wgmma is warp-aligned
      const uint32_t sa = tc::smem_u32(ring + stage * L::STAGE) + wgi * kBox;
      const uint32_t sb = tc::smem_u32(ring + stage * L::STAGE + L::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Mma<G::BN>::run(acc, sdesc(sa + 32 * kk, 16, 1024), sdesc(sb + 2048 * kk, kBox, 1024),
                        (k | kk) != 0);
      wgmma_commit();
      if (k > 0) {
        // the k-tile before this one is done: its stage is free
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);
    if constexpr (!GATE) {
      if (sp.splits > 1 && !fixup(acc, a.out_part + (size_t)x.tile * sp.splits * L::PART,
                                  sp.splits, x.s, a.out_counters + x.tile, last))
        continue;
    }

    // the epilogue: this warpgroup's 64 rows into its staging boxes (the
    // 128-byte swizzle: 16-byte chunk p of row r at chunk p ^ (r % 8)),
    // then TMA stores of the boxes
    if (tl == 0) bulk_wait_read();  // the previous unit's stores have read it
    named_sync(2 + wgi, 128);
    const int r0 = 16 * wq + g8;  // rows r0 and r0 + 8 of the warpgroup's 64
    if constexpr (GATE) {
      // (selects, not ba[x.tower]: a runtime index would put them in local memory)
      const bf16* wa = x.tower == 0 ? ba[0] : x.tower == 1 ? ba[1] : ba[2];
      const bf16* wb = x.tower == 0 ? bb[0] : x.tower == 1 ? bb[1] : bb[2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int hc = x.col + 64 * half + 8 * p + 2 * t4;
          const float2 ca = bias2(wa, hc), cb = bias2(wb, hc);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float v0 = (acc[16 * half + p][2 * hr] + ca.x) *
                             fmaxf(acc[16 * half + 8 + p][2 * hr] + cb.x, 0.f);
            const float v1 = (acc[16 * half + p][2 * hr + 1] + ca.y) *
                             fmaxf(acc[16 * half + 8 + p][2 * hr + 1] + cb.y, 0.f);
            const int r = r0 + 8 * hr;
            *reinterpret_cast<uint32_t*>(st + half * kBox + r * 128 + ((p ^ g8) << 4) + 4 * t4) =
                tc::pack_bf16(v0, v1);
          }
        }
    } else {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = x.col + 8 * q + 2 * t4;
        const float2 c0 = bias2(bc[0], col), c1 = bias2(bc[1], col), c2 = bias2(bc[2], col);
        const float lo0 = c0.x + c1.x + c2.x, lo1 = c0.y + c1.y + c2.y;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 8 * hr;
          *reinterpret_cast<uint32_t*>(st + (q / 8) * kBox + r * 128 + (((q % 8) ^ g8) << 4) +
                                       4 * t4) =
              tc::pack_bf16(acc[q][2 * hr] + lo0, acc[q][2 * hr + 1] + lo1);
        }
      }
    }
    fence_async_smem();
    named_sync(2 + wgi, 128);
    if (tl == 0) {
      const int row = x.rt * kRows + 64 * wgi;
#pragma unroll
      for (int j = 0; j < G::OUT_COLS / 64; ++j) {
        if constexpr (GATE)
          tma_store(&a.tma.g, st + j * kBox, x.col + 64 * j, row, x.tower);
        else
          tma_store(&a.tma.out, st + j * kBox, x.col + 64 * j, row);
      }
      bulk_commit();
    }
  }
  if (tl == 0) bulk_wait();
}

}  // namespace wg

// The wgmma route's two launches (the profiler's names keep the chain's:
// gate_kernel<...>, then out_kernel<..., false>(ldm::ftc::FwdArgs)).
template <class G>
__global__ void __launch_bounds__(wg::kThreads, 1) gate_kernel(const __grid_constant__ FwdArgs a) {
  wg::run<G>(a);
}
template <class G, bool CONV>
__global__ void __launch_bounds__(wg::kThreads, 1) out_kernel(const __grid_constant__ FwdArgs a) {
  static_assert(!CONV, "the wgmma route carries no conv");
  wg::run<G>(a);
}

namespace wg {

// The gate's tile: 128 hidden columns of a and of b. The output's: 128
// columns (on the H100 within 10% of 256 where those fill the card, 5-20%
// faster where they do not; PERF.md).
using GateT = WgGate<256>;
using OutT = WgOut<128>;

// k split over units where the tiles do not fill the card: the split
// count (at least 4 k-tiles a split) with the fewest k-tiles on the
// busiest block (waves of units over the SMs times k-tiles a unit), the
// least count among equals (a split costs its partials' round trip,
// which outweighs a part wave's gain where the tiles fill the card).
inline Split split_units(int tiles, int kt) {
  const int sms = tc::sm_count();
  Split best{1, kt};
  if (tiles >= sms) return best;
  long long best_t = kt;
  for (int s = 2; s <= kt / 4; ++s) {
    const int per = (kt + s - 1) / s, n = (kt + per - 1) / per;
    const long long t = (long long)(((long long)tiles * n + sms - 1) / sms) * per;
    if (t < best_t) {
      best = Split{n, per};
      best_t = t;
    }
  }
  return best;
}

// The gate's k is never split: the route's rule gives it a wave of tiles.
struct Plan {
  int gate_tiles, out_tiles;
  Split out;
  size_t floats;  // the output's split partials
  int counters;   // the output's split counters
};

inline Plan plan(int N, int C, int M) {
  Plan p;
  const int rows = (N + kRows - 1) / kRows;
  p.gate_tiles = rows * 3 * (M / GateT::OUT_COLS);
  p.out_tiles = rows * (C / OutT::BN);
  p.out = split_units(p.out_tiles, 3 * M / BK);
  const bool split = p.out.splits > 1;
  p.floats = split ? (size_t)p.out_tiles * p.out.splits * Layout<OutT>::PART : 0;
  p.counters = split ? p.out_tiles : 0;
  return p;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A map of a bf16 tensor of rank 2 or 3 (dims innermost first, row
// strides in elements) read and written in 64 x 64 boxes, 128-byte
// swizzled; reads past the tensor give zeros.
inline bool encode(TmaMap* m, const void* base, int rank, const uint64_t* dims,
                   const uint64_t* strides) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[3], s[2];
  for (int i = 0; i < rank; ++i) d[i] = dims[i];
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i] * sizeof(bf16);
  const cuuint32_t box[3] = {64, 64, 1}, el[3] = {1, 1, 1};
  return fn(reinterpret_cast<CUtensorMap*>(m), CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), d, s, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_maps(WgMaps& t, const FfnArgs& f) {
  const uint64_t N = f.N, C = f.C, M = f.M, E = f.E;
  const uint64_t nc[2] = {C, N}, cm[3] = {M, C, E}, mc[3] = {C, M, E}, g[3] = {M, N, 3};
  const uint64_t sc[2] = {C, C * M}, sm[2] = {M, M * C}, sg[2] = {M, N * M};
  return encode(&t.h, f.h, 2, nc, sc) && encode(&t.gwa, f.gwa, 2, cm, sm) &&
         encode(&t.gwb, f.gwb, 2, cm, sm) && encode(&t.wa, f.wa, 3, cm, sm) &&
         encode(&t.wb, f.wb, 3, cm, sm) && encode(&t.g, f.g, 3, g, sg) &&
         encode(&t.gwc, f.gwc, 2, mc, sc) && encode(&t.wc, f.wc, 3, mc, sc) &&
         encode(&t.out, f.out, 2, nc, sc);
}

// One launch of a wgmma-route kernel: kThreads-thread blocks, a
// programmatic dependent launch after the kernel before it.
inline cudaError_t launch_kernel(void (*kernel)(FwdArgs), int grid, size_t smem, cudaStream_t st,
                                 const FwdArgs& a) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr = tc::after_previous();
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The three launches of a bf16 call on this route (ffn_wgmma_route).
inline int forward(const FfnArgs& f, int* counters, cudaStream_t st) {
  const Plan p = plan(f.N, f.C, f.M);
  if (p.counters > kCounters) return (int)cudaErrorInvalidValue;
  FwdArgs a{f, Split{1, f.C / BK}, p.out, nullptr, f.scratch, nullptr, counters,
            ConvArgs{nullptr, nullptr, 0, 0}, nullptr};
  if (!encode_maps(a.tma, f)) return (int)cudaErrorInvalidValue;
  norm_film_rows_kernel<bf16><<<(f.N * 32 + 255) / 256, 256, 0, st>>>(
      (const bf16*)f.x, (const bf16*)f.mul, (const bf16*)f.bias, f.N, f.C, f.film_rows, 1e-4f,
      (bf16*)f.h);
  const int sms = tc::sm_count();
  cudaError_t e =
      launch_kernel(gate_kernel<GateT>, std::min(p.gate_tiles, sms), Layout<GateT>::smem, st, a);
  if (e != cudaSuccess) return (int)e;
  e = launch_kernel(out_kernel<OutT, false>, std::min(p.out_tiles * p.out.splits, sms),
                    Layout<OutT>::smem, st, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace wg
}  // namespace ftc
}  // namespace ldm
