// SwinBlock non-attention body: (out, h) with
//   h   = channel_norm(x) * film_mul + film_bias
//   out = [x +] ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
//         + conv3x3_grouped(h) + conv_bias
// The Hopper counterpart of block_core_pallas (both of its schedules):
// the FFN chain of ffn_common.cuh with the grouped conv (group width
// 32), its bias and the residual folded into the pass that writes out,
// so out is written once. dtype: 0 = float32, 1 = bfloat16; wq: 0 =
// FFN weights in dtype, 1 = int8 FFN weights with fp32 [2, out]
// scale-bias rows (block_core_pallas(quantized=True); the conv, its bias
// and the residual stay in dtype); scratch holds
// ffn_scratch_floats(B * H * W, C, M) floats.
#include "ffn_common.cuh"

extern "C" int block_core_forward(
    int dtype, int wq, const void* x, const void* mul, const void* bias, int film_rows,
    const void* gwa, const void* gba, const void* gwb, const void* gbb, const void* gwc,
    const void* gbc, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* bc, int E, const void* conv_kernel, const void* conv_bias,
    const void* ids, int add_residual, int B, int H, int W, int C, int M, void* out, void* h,
    void* g, void* scratch, void* stream) {
  const int N = B * H * W;
  ldm::FfnArgs a{x,  mul, bias, film_rows,       gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb,
                 bb, wc,  bc,   E, (const int*)ids, N,   C,   M,   out, h,   g,   (float*)scratch};
  const ldm::ConvArgs conv{conv_kernel, conv_bias, H, W};
  const void* residual = add_residual ? x : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return wq ? ldm::ffn_chain<float, int8_t>(a, conv, B, residual, st)
              : ldm::ffn_chain<float, float>(a, conv, B, residual, st);
  if (dtype == 1)
    return wq ? ldm::ffn_chain<bf16, int8_t>(a, conv, B, residual, st)
              : ldm::ffn_chain<bf16, bf16>(a, conv, B, residual, st);
  return (int)cudaErrorInvalidValue;
}
