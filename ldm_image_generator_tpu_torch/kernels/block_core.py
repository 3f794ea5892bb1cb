"""SwinBlock core: norm + FiLM + MoE FFN + grouped 3x3 conv + residual.

Replaces ``block_core_pallas`` (ldm_image_generator_tpu/kernels/
block_core.py:453; both its whole-image ``_kernel`` and its row-band
``_row_kernel`` schedules), forward only. Returns (out, h), [B, H, W, C]:

    h   = channel_norm(x) * film_mul + film_bias
    out = [x +] ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
          + conv3x3_grouped(h) + conv_bias

with the rounding points of ffn_block plus the conv, its bias and the
residual summed in fp32 before the one final rounding.

On the H100 (csrc/block_core.cu): at batch 1 the call is bound by bytes,
the 9 C x C FFN weight matrices it streams (the conv weights are 9 * 32
* C values). The TPU kernel held whole images or row bands with a halo
in 16 MB of VMEM; here the last pass of the chain takes one image row
and one 32-channel group per block, holds the row's 3 x (W + 2) x 32
window of h and the group's 9 x 32 x 32 taps in shared memory, and
sums the FFN partials, the conv, its bias and the residual there, so
out is written once. Products are the latency-hiding split-K fp32 FMA
loop of ffn_block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.kernels.ffn_block import (
    check_ffn_args,
    norm_film,
    reglu_sum_fp32,
)

# calls of block_core that launched the CUDA kernel chain
launches = 0
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


def block_core(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
               wa, ba, wb, bb, wc, bc, conv_kernel, conv_bias, expert_ids,
               add_residual: bool = True):
    """(out, h). CPU tensors take the plain version; CUDA tensors launch
    the kernel chain or raise."""
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
    smem = 4 * (3 * (ww + 2) * GROUP_WIDTH + 9 * GROUP_WIDTH ** 2)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"map width {ww} exceeds the conv pass's shared "
                         "memory")
    if conv_kernel.dtype != x.dtype or conv_bias.dtype != x.dtype:
        raise TypeError("conv params must have x's dtype")
    code = _build.dtype_code(x)
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    g = torch.empty((3, n, m), dtype=x.dtype, device=x.device)
    lib = _build.load("block_core")
    scratch = torch.empty(lib.ffn_scratch_floats(n, c, m), dtype=torch.float32,
                          device=x.device)
    p = _build.cuda_ptrs(x, film_mul, film_bias, *weights, conv_kernel,
                         conv_bias, expert_ids, out, h, g, scratch)
    rc = lib.block_core_forward(
        code, p[0], p[1], p[2], film_mul.shape[0] * hh * ww, *p[3:15], e,
        p[15], p[16], p[17], int(add_residual), b, hh, ww, c, m,
        p[18], p[19], p[20], p[21], _build.current_stream(),
    )
    _build.check(lib, rc, "block_core")
    global launches
    launches += 1
    return out, h
