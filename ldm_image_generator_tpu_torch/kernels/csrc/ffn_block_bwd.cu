// Backward of the SwinBlock FFN towers, the Hopper counterpart of
// ffn_block_bwd_pallas. From the saved h [N, C] and the out-cotangent g
// [N, C], for the general ReGLU and the two routed experts r:
//
//   a_r = h @ wa_r + ba_r,  b_r = h @ wb_r + bb_r      (fp32, recomputed)
//   dg_r = g @ wc_r^T                                   (fp32)
//   da_r = T(dg_r * relu(b_r)),  db_r = T(dg_r * a_r * [b_r > 0])
//   gate_r = T(a_r * relu(b_r))
//   dwa_r = h^T da_r, dba_r = sum_rows da_r, dwb_r = h^T db_r,
//   dbb_r = sum_rows db_r, dwc_r = gate_r^T g           (fp32)
//   dh = T(sum_r da_r @ wa_r^T + db_r @ wb_r^T)          (fp32 sum, one rounding)
//
// Four steps: gate_grad_kernel (the two recompute products and dg in one
// block, da/db/gate to scratch in T), the weight gradients as atb
// products over the N rows (split over blocks, partials added in a
// second pass; the bias gradients are the ones-row of h^T), and dh as one
// abt product over six segments. The TPU kernel carried the weight
// gradients in VMEM across a sequential grid; here blocks run in
// parallel and nothing carries between them.
// dtype: 0 = float32, 1 = bfloat16.
#include "ffn_common.cuh"
#include "grad_common.cuh"

namespace ldm {

struct FfnBwdArgs {
  const void *h, *g;
  const void *gwa, *gba, *gwb, *gbb, *gwc;
  const void *wa, *ba, *wb, *bb, *wc;
  int E;
  const int* ids;
  int N, C, M;
  void* dgate;  // T [3 (da, db, gate)][3 towers][N][M]
};

// grid (ceil(M / BN), ceil(N / BM), 3 towers).
template <typename T, typename S>
__global__ void __launch_bounds__(S::THREADS) gate_grad_kernel(FfnBwdArgs a) {
  const int r = blockIdx.z;
  const size_t cm = (size_t)a.C * a.M;
  const T *wa, *ba, *wb, *bb, *wc;
  if (r == 0) {
    wa = (const T*)a.gwa; ba = (const T*)a.gba; wb = (const T*)a.gwb; bb = (const T*)a.gbb;
    wc = (const T*)a.gwc;
  } else {
    wa = expert_slice((const T*)a.wa, a.ids, r - 1, a.E, cm);
    ba = expert_slice((const T*)a.ba, a.ids, r - 1, a.E, (size_t)a.M);
    wb = expert_slice((const T*)a.wb, a.ids, r - 1, a.E, cm);
    bb = expert_slice((const T*)a.bb, a.ids, r - 1, a.E, (size_t)a.M);
    wc = expert_slice((const T*)a.wc, a.ids, r - 1, a.E, cm);
  }
  __shared__ TileSmem<S, 2> sm_ab;
  __shared__ TileSmem<S, 1> sm_dg;
  float ab[2][S::TM][S::TN], dg[1][S::TM][S::TN];
  zero_acc<S, 2>(ab);
  zero_acc<S, 1>(dg);
  const int row0 = blockIdx.y * S::BM, col0 = blockIdx.x * S::BN;
  const T* Bab[2] = {wa, wb};
  tile_product<S, 2>((const T*)a.h, a.C, a.N, a.C, row0, Bab, a.M, a.M, col0, 0, a.C, sm_ab, ab);
  // dg = g @ wc^T: wc [M, C] read transposed
  const T* Bdg[1] = {wc};
  tile_product<S, 1, false, true>((const T*)a.g, a.C, a.N, a.C, row0, Bdg, a.C, a.M, col0, 0,
                                  a.C, sm_dg, dg);
  const size_t nm = (size_t)a.N * a.M;
  T* da = (T*)a.dgate + (size_t)r * nm;
  T* db = (T*)a.dgate + (size_t)(3 + r) * nm;
  T* gate = (T*)a.dgate + (size_t)(6 + r) * nm;
#pragma unroll
  for (int i = 0; i < S::TM; ++i) {
    const int row = acc_row<S>(i);
    if (row >= a.N) continue;
#pragma unroll
    for (int j = 0; j < S::TN; ++j) {
      const int col = acc_col<S>(j);
      if (col >= a.M) continue;
      const float av = ab[0][i][j] + to_f(ba[col]);
      const float bv = ab[1][i][j] + to_f(bb[col]);
      const float relu_b = fmaxf(bv, 0.f);
      const float d = dg[0][i][j];
      const size_t o = (size_t)row * a.M + col;
      da[o] = from_f<T>(d * relu_b);
      db[o] = from_f<T>(d * av * (bv > 0.f ? 1.f : 0.f));
      gate[o] = from_f<T>(av * relu_b);
    }
  }
}

// grads: per tower r, [dwa (C x M) | dba (M)] [dwb | dbb] [dwc (M x C)],
// fp32; towers at stride ffn_bwd_tower_floats.
inline size_t tower_floats(int C, int M) { return (size_t)2 * (C + 1) * M + (size_t)M * C; }

inline size_t bwd_scratch_floats(int N, int C, int M) {
  const size_t w1 = atb_part_floats(6, C, M, N, 1);
  const size_t w2 = atb_part_floats(3, M, C, N, 0);
  const size_t d = abt_plan(6, N, M, C).floats;
  size_t f = w1 > w2 ? w1 : w2;
  return f > d ? f : d;
}

template <typename T>
int ffn_backward(const FfnBwdArgs& a, void* dh, float* grads, float* scratch, cudaStream_t st) {
  const int N = a.N, C = a.C, M = a.M;
  if (use_large_tile(N, M)) {
    dim3 grid((M + TileL::BN - 1) / TileL::BN, (N + TileL::BM - 1) / TileL::BM, 3);
    gate_grad_kernel<T, TileL><<<grid, TileL::THREADS, 0, st>>>(a);
  } else {
    dim3 grid((M + TileS::BN - 1) / TileS::BN, (N + TileS::BM - 1) / TileS::BM, 3);
    gate_grad_kernel<T, TileS><<<grid, TileS::THREADS, 0, st>>>(a);
  }
  const size_t nm = (size_t)N * M, tw = tower_floats(C, M);
  const T* dg = (const T*)a.dgate;
  // dwa_r | dba_r and dwb_r | dbb_r: h^T [da_r | db_r], ones-row = bias
  AtbArgs w1{};
  w1.nmat = 6;
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 2; ++q) {
      const int z = 2 * r + q;
      w1.A[z] = a.h;
      w1.lda[z] = C;
      w1.B[z] = dg + (size_t)(3 * q + r) * nm;
      w1.ldb[z] = M;
      w1.out[z] = grads + r * tw + (size_t)q * (C + 1) * M;
    }
  w1.K = N; w1.R = C; w1.ncol = M; w1.ones = 1; w1.part = scratch;
  atb<T>(w1, st);
  // dwc_r = gate_r^T g
  AtbArgs w2{};
  w2.nmat = 3;
  for (int r = 0; r < 3; ++r) {
    w2.A[r] = dg + (size_t)(6 + r) * nm;
    w2.lda[r] = M;
    w2.B[r] = a.g;
    w2.ldb[r] = C;
    w2.out[r] = grads + r * tw + (size_t)2 * (C + 1) * M;
  }
  w2.K = N; w2.R = M; w2.ncol = C; w2.ones = 0; w2.part = scratch;
  atb<T>(w2, st);
  // dh = T(sum_r da_r wa_r^T + db_r wb_r^T): weights [C, M] read transposed
  AbtArgs d{};
  d.nseg = 6;
  const size_t cm = (size_t)C * M;
  const void* wsel[2][2] = {{a.gwa, a.wa}, {a.gwb, a.wb}};
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 2; ++q) {
      const int z = 2 * r + q;
      d.A[z] = dg + (size_t)(3 * q + r) * nm;
      d.lda[z] = M;
      d.B[z] = r == 0 ? WeightRef{wsel[q][0], -1, 0} : WeightRef{wsel[q][1], r - 1, cm};
    }
  d.ldb = M; d.ids = a.ids; d.E = a.E; d.N = N; d.K = M; d.ncol = C; d.out = dh; d.part = scratch;
  abt<T>(d, st);
  return (int)cudaGetLastError();
}

}  // namespace ldm

extern "C" int ffn_block_backward(int dtype, const void* h, const void* g, const void* gwa,
                                  const void* gba, const void* gwb, const void* gbb,
                                  const void* gwc, const void* wa, const void* ba,
                                  const void* wb, const void* bb, const void* wc, int E,
                                  const void* ids, int N, int C, int M, void* dh, void* dgate,
                                  void* grads, void* scratch, void* stream) {
  const ldm::FfnBwdArgs a{h,  g,  gwa, gba, gwb, gbb, gwc, wa, ba, wb,
                          bb, wc, E,   (const int*)ids,     N,   C,  M,  dgate};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ldm::ffn_backward<float>(a, dh, (float*)grads, (float*)scratch, st);
  if (dtype == 1)
    return ldm::ffn_backward<__nv_bfloat16>(a, dh, (float*)grads, (float*)scratch, st);
  return (int)cudaErrorInvalidValue;
}

// fp32 floats of the gradient buffer (3 towers) and of the scratch.
extern "C" long long ffn_bwd_grad_floats(int C, int M) {
  return (long long)(3 * ldm::tower_floats(C, M));
}

extern "C" long long ffn_bwd_scratch_floats(int N, int C, int M) {
  return (long long)ldm::bwd_scratch_floats(N, C, M);
}
