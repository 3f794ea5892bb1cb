"""The kernels' call shapes on the sampling path, random inputs at those
shapes, and the least work each call needs (for roofline bounds).

Used by chip_smoke.py and the CUDA kernel tests to hold each kernel
against its plain version at the shapes the UNet gives it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ldm_image_generator_tpu_torch.config import UNetConfig

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


@dataclasses.dataclass(frozen=True)
class Call:
    """One kernel call shape on the path and its count per denoise step."""

    kernel: str            # block_core | ffn_block | window_mha
    batch: int
    hw: int                # map side (block kernels) or 0
    c: int
    per_step: int          # calls per denoise step
    n: int = 0             # window_mha: windows
    l: int = 0             # window_mha: tokens per window
    heads: int = 0
    masked: bool = False

    @property
    def label(self) -> str:
        if self.kernel == "window_mha":
            return f"[{self.n},{self.l},{self.c}] h{self.heads}" + (
                " mask" if self.masked else "")
        return f"[{self.batch},{self.hw},{self.hw},{self.c}]"


def path_calls(batch: int, latent: int = 32,
               cfg: UNetConfig = UNetConfig()) -> list:
    """Every distinct kernel call of one UNet forward at `batch`: the
    block body (block_core at batch <= 2, else ffn_block) of every
    block, and window_mha for the attention blocks."""
    body = "block_core" if batch <= 2 else "ffn_block"
    calls = []
    ws = cfg.window_size
    for i, (c, nb) in enumerate(zip(cfg.channels, cfg.stages)):
        hw = (latent // cfg.stem_size) >> i
        calls.append(Call(body, batch, hw, c, per_step=2 * nb))
        n_attn = min(2, nb)
        heads = max(1, c // cfg.head_dim)
        if hw <= ws:
            calls.append(Call("window_mha", batch, 0, c, n_attn, n=batch,
                              l=hw * hw, heads=heads))
        else:
            nwin = math.ceil(hw / ws) ** 2
            calls.append(Call("window_mha", batch, 0, c, n_attn,
                              n=batch * nwin, l=ws * ws, heads=heads,
                              masked=True))
    return calls


def _randn(shape, gen, device, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen, device=device) * scale + shift


def make_inputs(call: Call, dtype: torch.dtype, device,
                gen: torch.Generator) -> tuple:
    """Positional arguments of the kernel wrapper for `call` (weights at
    lecun scale, biases and FiLM random, film at batch 1; FFN width M = C
    as ffn_mul=1 gives), cast to dtype."""
    c = m = call.c
    e = 4
    cast = lambda t: t.to(dtype).contiguous()
    w = lambda *s, fan: cast(_randn(s, gen, device, fan ** -0.5))
    b = lambda *s: cast(_randn(s, gen, device, 0.05))
    if call.kernel == "window_mha":
        x = cast(_randn((call.n, call.l, c), gen, device))
        mask = None
        if call.masked:
            mask = torch.zeros((call.n, call.l), dtype=torch.bool, device=device)
            mask[:, -call.l // 6:] = True  # a padded edge window's keys
        return (x, mask, w(c, c, fan=c), b(c), w(c, c, fan=c), b(c),
                w(c, c, fan=c), b(c), w(c, c, fan=c), b(c))
    hw, bt = call.hw, call.batch
    x = cast(_randn((bt, hw, hw, c), gen, device))
    mul = cast(_randn((1, hw, hw, c), gen, device, 0.2, 1.0))
    bias = cast(_randn((1, hw, hw, c), gen, device, 0.2))
    ffn = (w(c, m, fan=c), b(m), w(c, m, fan=c), b(m), w(m, c, fan=m), b(c),
           w(e, c, m, fan=c), b(e, m), w(e, c, m, fan=c), b(e, m),
           w(e, m, c, fan=m), b(e, c))
    ids = torch.tensor((1, 3), dtype=torch.int32, device=device)
    if call.kernel == "ffn_block":
        return (x.reshape(-1, c), mul.reshape(-1, c), bias.reshape(-1, c),
                *ffn, ids)
    conv_k = w(3, 3, 32, c, fan=9 * 32)
    return (x, mul, bias, *ffn, conv_k, b(c), ids)


def work(call: Call, dtype: torch.dtype):
    """(bytes, flops) the call needs: each input read once (only the two
    selected experts' weights), each output written once."""
    it = torch.finfo(dtype).bits // 8
    c = m = call.c
    if call.kernel == "window_mha":
        rows = call.n * call.l
        nbytes = it * (2 * rows * c + 4 * c * c + 4 * c) + (
            call.n * call.l if call.masked else 0)
        flops = 8 * rows * c * c + 4 * call.n * call.l * call.l * c
        return nbytes, flops
    rows = call.batch * call.hw * call.hw
    film = 2 * call.hw * call.hw * c
    weights = 3 * (3 * c * m + 2 * m + c)  # general + two experts
    nbytes = it * (rows * c + film + weights + 2 * rows * c) + 8
    flops = 18 * rows * c * m
    if call.kernel == "block_core":
        nbytes += it * (9 * 32 * c + c)
        flops += 2 * rows * c * 9 * 32
    return nbytes, flops


def bound_ms(call: Call, dtype: torch.dtype):
    """(least ms on an H100 at its published peaks, 'bytes'|'operations')."""
    nbytes, flops = work(call, dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
