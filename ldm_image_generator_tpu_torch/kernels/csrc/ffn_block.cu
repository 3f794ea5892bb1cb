// Fused SwinBlock FFN prologue on rows: (out, h) with
//   h   = channel_norm(x) * film_mul + film_bias
//   out = ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
// The Hopper counterpart of ffn_block_pallas
// (ldm_image_generator_tpu/kernels/ffn_block.py). dtype: 0 = float32,
// 1 = bfloat16; scratch holds ffn_block_scratch_floats(dtype, N, C, M)
// floats, counters ffn_counter_ints() zeroed ints.
//
// At the widths ffn_tc.cuh takes (every UNet shape) a call runs on the
// tensor cores in three launches (norm/FiLM, the gate, the output product
// with the biases in its epilogue). bfloat16 with bf16 weights at the row
// counts ffn_wgmma_route takes (batched sampling, served buckets from 16
// up, from 4 or 8 up at the wider maps): wgmma tiles of 128 rows fed by TMA
// from a producer warp (ffn_wg_fwd.cuh), because there the 18 N C M FLOP
// bound a call at C >= 256 and the bytes of x, h, g and out at C = 128,
// and mma.sync's 64-row four-warp blocks reached a tenth of either; the
// wgmma route reaches 40-55% and ~60% (PERF.md). Elsewhere (fewer rows,
// int8 weights, float32): ffn_tc_fwd.cuh, bf16 mma.sync or, for float32,
// fp32-accurate TF32 passes (ffn_tf32_fwd.cuh: three per product with fp32
// weights, two with int8 ones). At the B=1-4 sampling shapes with C >= 512
// (N <= 256 rows) the 9 C x M weight matrices' bytes (4.7-18.9 MB in bf16)
// bound a call; against them split-K, 4-deep cp.async rings (2-3 with fp32
// weights) and programmatic dependent launches, and there every block runs
// only 2-8 k-tiles, so the three launches' latency sets a call's time
// (PERF.md).
// Other widths keep the CUDA-core FMA chain of ffn_common.cuh.
//
// int8 weights (wq = 1; ffn_block_pallas(quantized=True)): the same
// launches and plans on either route (ffn_tc_fwd.cuh, ffn_common.cuh).
// The weight bytes halve against bf16 (a quarter of fp32's); a call stays
// bound by the same launch latency (PERF.md).
#include "ffn_wg_fwd.cuh"

// The calls the bf16 wgmma route takes (ffn_wg_fwd.cuh): bf16 activations
// and weights, C and M multiples of 128 (every UNet width) and enough rows
// that the gate's tiles (128 rows by 128 hidden columns, three towers)
// fill the card once, one persistent block an SM. A sweep of the
// benchmark's call shapes on the H100 (PERF.md) put the crossover
// there: below it the gate's k must split and the route loses to the
// mma.sync kernels (C=512 at 1,024 rows, C=1024 at 256) or ties them.
// It depends on the dtype, the weights' type and the shape alone.
extern "C" int ffn_wgmma_route(int dtype, int wq, int N, int C, int M) {
  if (dtype != 1 || wq != 0 || !ldm::ftc::takes(N, C, M) || C % 128 != 0 || M % 128 != 0)
    return 0;
  return ldm::ftc::wg::plan(N, C, M).gate_tiles >= ldm::tc::sm_count();
}

// fp32 scratch (split partial sums) one call needs, for the wrapper.
extern "C" long long ffn_block_scratch_floats(int dtype, int N, int C, int M) {
  if (ffn_tensor_cores(dtype, N, C, M)) {
    // (the wgmma route's plan where a bf16 call may take it)
    const size_t mma = ldm::ftc::fwd_plan(N, C, M, false).floats;
    const size_t wg = ffn_wgmma_route(dtype, 0, N, C, M) ? ldm::ftc::wg::plan(N, C, M).floats : 0;
    return (long long)(mma > wg ? mma : wg);
  }
  return ffn_scratch_floats(N, C, M);
}

// wq: 0 = weights in the compute dtype, 1 = int8 weights with fp32
// [2, out] scale-bias rows in place of the biases (ffn_common.cuh).
extern "C" int ffn_block_forward(
    int dtype, int wq, const void* x, const void* mul, const void* bias, int film_rows,
    const void* gwa, const void* gba, const void* gwb, const void* gbb, const void* gwc,
    const void* gbc, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* bc, int E, const void* ids, int N, int C, int M, void* out,
    void* h, void* g, void* scratch, void* counters, void* stream) {
  ldm::FfnArgs a{x,  mul, bias, film_rows,       gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb,
                 bb, wc,  bc,   E, (const int*)ids, N,   C,   M,   out, h,   g,   (float*)scratch};
  const ldm::ConvArgs none{nullptr, nullptr, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ffn_wgmma_route(dtype, wq, N, C, M))
    return ldm::ftc::wg::forward(a, (int*)counters, st);
  if (ffn_tensor_cores(dtype, N, C, M)) {
    if (dtype == 0)
      return wq ? ldm::ftc::forward<float, true>(a, none, nullptr, (int*)counters, st)
                : ldm::ftc::forward<float, false>(a, none, nullptr, (int*)counters, st);
    return wq ? ldm::ftc::forward<__nv_bfloat16, true>(a, none, nullptr, (int*)counters, st)
              : ldm::ftc::forward<__nv_bfloat16, false>(a, none, nullptr, (int*)counters, st);
  }
  if (dtype == 0)
    return wq ? ldm::ffn_chain<float, int8_t>(a, none, 1, nullptr, st)
              : ldm::ffn_chain<float, float>(a, none, 1, nullptr, st);
  if (dtype == 1)
    return wq ? ldm::ffn_chain<__nv_bfloat16, int8_t>(a, none, 1, nullptr, st)
              : ldm::ffn_chain<__nv_bfloat16, __nv_bfloat16>(a, none, 1, nullptr, st);
  return (int)cudaErrorInvalidValue;
}
