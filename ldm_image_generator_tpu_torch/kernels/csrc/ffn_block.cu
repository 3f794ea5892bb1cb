// Fused SwinBlock FFN prologue on rows: (out, h) with
//   h   = channel_norm(x) * film_mul + film_bias
//   out = ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
// The Hopper counterpart of ffn_block_pallas; the kernels are in
// ffn_common.cuh. dtype: 0 = float32, 1 = bfloat16; scratch holds
// ffn_scratch_floats(N, C, M) floats.
#include "ffn_common.cuh"

extern "C" int ffn_block_forward(
    int dtype, const void* x, const void* mul, const void* bias, int film_rows,
    const void* gwa, const void* gba, const void* gwb, const void* gbb, const void* gwc,
    const void* gbc, const void* wa, const void* ba, const void* wb, const void* bb,
    const void* wc, const void* bc, int E, const void* ids, int N, int C, int M, void* out,
    void* h, void* g, void* scratch, void* stream) {
  ldm::FfnArgs a{x,  mul, bias, film_rows,       gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb,
                 bb, wc,  bc,   E, (const int*)ids, N,   C,   M,   out, h,   g,   (float*)scratch};
  const ldm::ConvArgs none{nullptr, nullptr, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ldm::ffn_chain<float>(a, none, 1, nullptr, st);
  if (dtype == 1) return ldm::ffn_chain<__nv_bfloat16>(a, none, 1, nullptr, st);
  return (int)cudaErrorInvalidValue;
}
