"""SwinBlock core: norm + FiLM + MoE FFN + grouped 3x3 conv + residual.

Replaces ``block_core_pallas`` (ldm_image_generator_tpu/kernels/
block_core.py:453; both its whole-image ``_kernel`` and its row-band
``_row_kernel`` schedules). Returns (out, h), [B, H, W, C]:

    h   = channel_norm(x) * film_mul + film_bias
    out = [x +] ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
          + conv3x3_grouped(h) + conv_bias

with the rounding points of ffn_block plus the conv, its bias and the
residual summed in fp32 before the one final rounding.

On the H100 (csrc/block_core.cu): at batch 1 the call is bound by bytes,
the 9 C x C FFN weight matrices it streams (the conv weights are 9 * 32
* C values). The TPU kernel held whole images or row bands with a halo
in 16 MB of VMEM. Here bfloat16 at the widths ``block_core_tensor_cores`` takes
(C a multiple of 64 up to 1024: every UNet shape; the route depends on
dtype and shape alone) runs ffn_block's three tensor-core launches
(csrc/ffn_tc_fwd.cuh): the output product's k-loop runs on over 9 more
k-tiles, one per conv tap, each a product of h shifted by the tap (zero
rows outside the image) with that tap's weights, each warp's 32 output
columns being one conv group; the conv bias and the residual join the
output biases in its epilogue, so out is written once. float32 runs the
same three launches on the tensor cores, fp32 accurate
(csrc/ffn_tf32_fwd.cuh, ``block_core_tensor_cores``): three TF32 passes
per product with float32 FFN weights; with int8 ones the weight tiles
stay int8 until the fragment load and each tower product takes two
passes (an int8 value is exact in TF32), the conv three. Other widths
keep the FMA chain of ffn_block, whose last pass takes one image row and
one 32-channel group per block with the row's 3 x (W + 2) x 32 window of
h and the group's taps in shared memory.

int8 FFN weights (``block_core_pallas(..., quantized=True)``; see
ffn_block.py): the same routes with the weights read as int8 and each
product scaled per column before its bias; the grouped conv, its bias
and the residual stay in the compute dtype. The row-band schedule of the
TPU kernel (a VMEM workaround) has no counterpart here either. Training
through them takes ffn_block's route (``int8=``): the forward on the int8
weights, the backward at the dequantized ones with straight-through
weight gradients.

Gradients: ``block_core`` is an autograd Function. The TPU kernel had no
backward of its own (its custom_vjp took the XLA VJP of block_core_xla);
here the backward is composed from the ported pieces: the FFN towers'
backward kernel on the saved h (ffn_block.ffn_tower_bwd), PyTorch's own
gradient of the grouped conv, the residual, and the norm/FiLM backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.kernels.ffn_block import (
    _check_chunk_aligned,
    _split_counters,
    check_ffn_args,
    ffn_tower_bwd,
    check_int8,
    int8_routes,
    norm_film,
    reglu_sum_fp32,
)

# calls of block_core (full-precision and int8 FFN weights) that launched
# the CUDA kernel chain
launches = 0
int8_launches = 0
# the conv pass takes the UNet's grouped conv: groups of 32 channels
GROUP_WIDTH = 32


def grouped_conv3x3(h: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 grouped conv of NHWC h with an HWIO [3, 3, gw, C] kernel
    (groups = C / gw), in h's dtype."""
    c = h.shape[-1]
    gw = kernel.shape[2]
    y = F.conv2d(h.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=1, groups=c // gw)
    return y.permute(0, 2, 3, 1) + bias


def block_core_plain(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
                     wa, ba, wb, bb, wc, bc, conv_kernel, conv_bias,
                     expert_ids, add_residual: bool = True):
    """Plain PyTorch version: x [B, H, W, C]; film [1 or B, H, W, C]."""
    c = x.shape[-1]
    h = norm_film(x.reshape(-1, c), film_mul.reshape(-1, c),
                  film_bias.reshape(-1, c))
    out = reglu_sum_fp32(h, gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb,
                         wc, bc, expert_ids).reshape(x.shape)
    h4 = h.reshape(x.shape)
    out = out + grouped_conv3x3(h4.float(), conv_kernel.float(),
                                conv_bias.float())
    if add_residual:
        out = out + x.float()
    return out.to(x.dtype), h4


def _block_core_forward(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc,
                        gbc, wa, ba, wb, bb, wc, bc, conv_kernel, conv_bias,
                        expert_ids, add_residual: bool = True):
    """(out, h): the plain version for CPU tensors, the kernel chain for
    CUDA tensors (or an exception)."""
    if x.device.type == "cpu":
        return block_core_plain(x, film_mul, film_bias, gwa, gba, gwb, gbb,
                                gwc, gbc, wa, ba, wb, bb, wc, bc, conv_kernel,
                                conv_bias, expert_ids, add_residual)
    b, hh, ww, c = x.shape
    if film_mul.shape[1:] != x.shape[1:] or film_mul.shape[0] not in (1, b):
        raise ValueError(f"film {tuple(film_mul.shape)} for x {tuple(x.shape)}")
    weights = (gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc)
    n, _, m, e = check_ffn_args(x.reshape(-1, c), film_mul.reshape(-1, c),
                                film_bias.reshape(-1, c), weights, expert_ids)
    if (tuple(conv_kernel.shape) != (3, 3, GROUP_WIDTH, c) or c % GROUP_WIDTH
            or tuple(conv_bias.shape) != (c,)):
        raise ValueError(f"conv kernel {tuple(conv_kernel.shape)} / bias "
                         f"{tuple(conv_bias.shape)}: the kernel takes group "
                         f"width {GROUP_WIDTH} and C={c} a multiple of it")
    if conv_kernel.dtype != x.dtype or conv_bias.dtype != x.dtype:
        raise TypeError("conv params must have x's dtype")
    code, q = _build.dtype_code(x), gwa.dtype == torch.int8
    lib = _build.load("block_core")
    if lib.block_core_smem_bytes(code, int(q), n, c, m, ww) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"map width {ww} exceeds the conv pass's shared "
                         "memory")
    _check_chunk_aligned(lib.block_core_tensor_cores(code, int(q), n, c, m), x,
                         film_mul, film_bias, gwa, gwb, gwc, wa, wb, wc,
                         conv_kernel)
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    g = torch.empty((3, n, m), dtype=x.dtype, device=x.device)
    scratch = torch.empty(lib.block_core_scratch_floats(code, int(q), n, c, m),
                          dtype=torch.float32, device=x.device)
    p = _build.cuda_ptrs(x, film_mul, film_bias, *weights, conv_kernel,
                         conv_bias, expert_ids, out, h, g, scratch,
                         _split_counters(lib, x.device))
    rc = lib.block_core_forward(
        code, int(q), p[0], p[1], p[2], film_mul.shape[0] * hh * ww,
        *p[3:15], e, p[15], p[16], p[17], int(add_residual), b, hh, ww, c,
        m, *p[18:], _build.current_stream(),
    )
    _build.check(lib, rc, "block_core")
    global launches, int8_launches
    if q:
        int8_launches += 1
    else:
        launches += 1
    return out, h


class _BlockCore(torch.autograd.Function):
    """block_core with a backward composed from the ported pieces (see
    the module note); the film cotangent of a batch-1 film is summed over
    the batch. int8 copies as in ffn_block's _FfnBlock."""

    @staticmethod
    def forward(ctx, x, film_mul, film_bias, conv_kernel, conv_bias, expert_ids,
                add_residual, int8, *weights):
        run, at = int8_routes(weights, int8)
        out, h = _block_core_forward(x, film_mul, film_bias, *run, conv_kernel,
                                     conv_bias, expert_ids, add_residual=add_residual)
        ctx.add_residual = add_residual
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, film_mul, film_bias, conv_kernel, conv_bias,
                              expert_ids, h, *at)
        return out, h

    @staticmethod
    def backward(ctx, g, gh):
        x, film_mul, film_bias, ck, cb, ids, h, *weights = ctx.saved_tensors
        n_in = len(weights) + 8
        if g is None and gh is None:
            return (None,) * n_in
        c = x.shape[-1]
        g = torch.zeros_like(x) if g is None else g.to(x.dtype).contiguous()
        # the grouped conv's gradient, in fp32 as the forward sums it
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (h, ck, cb)]
            y = grouped_conv3x3(*leaves)
            dh_conv, dck, dcb = torch.autograd.grad(y, leaves, g.float())
        dh_extra = dh_conv if gh is None else dh_conv + gh.float()
        rows = lambda t: t.reshape(-1, c)
        dx, dmul, dbias, *dw = ffn_tower_bwd(
            rows(x), rows(film_mul), rows(film_bias), weights, ids, rows(h),
            rows(g), rows(dh_extra))
        dx = dx.reshape(x.shape)
        if ctx.add_residual:
            dx = (dx.float() + g.float()).to(x.dtype)
        return (dx, dmul.reshape(film_mul.shape), dbias.reshape(film_bias.shape),
                dck.to(ck.dtype), dcb.to(cb.dtype), None, None, None, *dw)


def block_core(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
               wa, ba, wb, bb, wc, bc, conv_kernel, conv_bias, expert_ids,
               add_residual: bool = True, int8=None):
    """(out, h), differentiable in every input but the ids. CPU tensors
    take the plain versions; CUDA tensors launch the kernel chains or
    raise. Grad mode off skips the autograd Function (see ffn_block);
    int8: the int8 route of full-precision FFN weights, as ffn_block's."""
    weights = (gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc)
    check_int8(weights, int8)
    if not torch.is_grad_enabled():
        return _block_core_forward(x, film_mul, film_bias,
                                   *(weights if int8 is None else int8[0]),
                                   conv_kernel, conv_bias, expert_ids, add_residual)
    return _BlockCore.apply(x, film_mul, film_bias, conv_kernel, conv_bias,
                            expert_ids, add_residual, int8, *weights)
