// SwinBlock non-attention body: (out, h) with
//   h   = channel_norm(x) * film_mul + film_bias
//   out = [x +] ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
//         + conv3x3_grouped(h) + conv_bias
// The Hopper counterpart of block_core_pallas (both of its schedules).
// dtype: 0 = float32, 1 = bfloat16; wq: 0 = FFN weights in dtype, 1 =
// int8 FFN weights with fp32 [2, out] scale-bias rows
// (block_core_pallas(quantized=True); the conv, its bias and the residual
// stay in dtype); scratch holds block_core_scratch_floats(dtype, wq, B *
// H * W, C, M) floats, counters ffn_counter_ints() zeroed ints.
//
// At the widths ffn_tc.cuh takes (C and M multiples of 64, C <= 1024:
// every UNet shape) every call runs on the tensor cores in the three
// launches of ffn_tc_fwd.cuh: bf16 mma.sync for bfloat16, for float32
// fp32-accurate TF32 passes (ffn_tf32_fwd.cuh: three per product with
// fp32 FFN weights, two with int8 ones), the grouped conv (group width
// 32) as 9 more k-tiles of the output product and its bias and the
// residual in that kernel's epilogue, so out is written once. At batch 1
// a call is bound by the 9 C x C FFN weight matrices' bytes on paper, by
// the three launches' latency in practice (PERF.md).
// Other widths keep the FMA chain of ffn_common.cuh: its last pass takes
// one image row and one 32-channel group per block, holds the row's 3 x
// (W + 2) x 32 window of h and the group's taps in shared memory, and
// sums the FFN partials, the conv, its bias and the residual there.
#include "ffn_tc_fwd.cuh"

// The route of a call: the tensor cores (1) or the FMA chain (0), by the
// dtype and the shape alone (either weight type), as ffn_block's
// ffn_tensor_cores.
extern "C" int block_core_tensor_cores(int dtype, int wq, int N, int C, int M) {
  return (dtype == 0 || dtype == 1) && ldm::ftc::takes(N, C, M);
}

// fp32 scratch (split partial sums) one call needs, for the wrapper.
extern "C" long long block_core_scratch_floats(int dtype, int wq, int N, int C, int M) {
  if (block_core_tensor_cores(dtype, wq, N, C, M))
    return (long long)ldm::ftc::fwd_plan(N, C, M, true).floats;
  return ffn_scratch_floats(N, C, M);
}

// Dynamic shared memory the largest launch of a call's route needs, for
// a map W pixels wide.
extern "C" long long block_core_smem_bytes(int dtype, int wq, int N, int C, int M, int W) {
  if (block_core_tensor_cores(dtype, wq, N, C, M))
    return (long long)(dtype == 0 ? (wq ? ldm::ftc::fwd_smem<float, true>(true)
                                        : ldm::ftc::fwd_smem<float, false>(true))
                       : wq       ? ldm::ftc::fwd_smem<__nv_bfloat16, true>(true)
                                  : ldm::ftc::fwd_smem<__nv_bfloat16, false>(true));
  return (long long)ldm::conv_smem_bytes(W);
}

extern "C" int block_core_forward(
    int dtype, int wq, const void* x, const void* mul, const void* bias, int film_rows,
    const void* gwa, const void* gba, const void* gwb, const void* gbb, const void* gwc,
    const void* gbc, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* bc, int E, const void* conv_kernel, const void* conv_bias,
    const void* ids, int add_residual, int B, int H, int W, int C, int M, void* out, void* h,
    void* g, void* scratch, void* counters, void* stream) {
  const int N = B * H * W;
  ldm::FfnArgs a{x,  mul, bias, film_rows,       gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb,
                 bb, wc,  bc,   E, (const int*)ids, N,   C,   M,   out, h,   g,   (float*)scratch};
  const ldm::ConvArgs conv{conv_kernel, conv_bias, H, W};
  const void* residual = add_residual ? x : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (block_core_tensor_cores(dtype, wq, N, C, M)) {
    if (dtype == 0)
      return wq ? ldm::ftc::forward<float, true>(a, conv, residual, (int*)counters, st)
                : ldm::ftc::forward<float, false>(a, conv, residual, (int*)counters, st);
    return wq ? ldm::ftc::forward<bf16, true>(a, conv, residual, (int*)counters, st)
              : ldm::ftc::forward<bf16, false>(a, conv, residual, (int*)counters, st);
  }
  if (dtype == 0)
    return wq ? ldm::ffn_chain<float, int8_t>(a, conv, B, residual, st)
              : ldm::ffn_chain<float, float>(a, conv, B, residual, st);
  if (dtype == 1)
    return wq ? ldm::ffn_chain<bf16, int8_t>(a, conv, B, residual, st)
              : ldm::ffn_chain<bf16, bf16>(a, conv, B, residual, st);
  return (int)cudaErrorInvalidValue;
}
