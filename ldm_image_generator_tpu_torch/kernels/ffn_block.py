"""Fused SwinBlock FFN prologue: norm + FiLM + 3-ReGLU MoE sum, on rows.

Replaces ``ffn_block_pallas`` (ldm_image_generator_tpu/kernels/
ffn_block.py:221), forward only. Returns (out, h):

    h   = channel_norm(x) * film_mul + film_bias
    out = ReGLU_general(h) + ReGLU_e1(h) + ReGLU_e2(h)
    ReGLU(h) = ((h @ wa + ba) * relu(h @ wb + bb)) @ wc + bc

Rounding points (as the Pallas kernel): h is rounded to the working type
before the products; a and b are fp32 plus bias and the gate is rounded
to the working type; the sum of the three output products and the
output biases is fp32, rounded once.

On the H100 (csrc/ffn_block.cu, chain of csrc/ffn_common.cuh): at the
sampling shapes the work is bound by bytes, the 9 C x C weight matrices
of the general and the two selected experts, streamed once per call
(the expert ids are read from device memory, so only those two slices
are read and the host never waits). With few rows each block's k-loop
waits on device-memory latency, so the next k-tile is fetched while
the current one is multiplied and k is split over blocks until the card
has about four blocks per SM; fp32 partial sums meet in an elementwise
pass. h, the gate g and the partials live in scratch this wrapper
allocates. The product is a shared-memory-tiled fp32 FMA loop on the
CUDA cores, not yet the tensor cores. Film rows repeat with period
film_mul.shape[0], so the batch-1 FiLM schedule needs no broadcast copy.
"""
from __future__ import annotations

import torch

from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.ops.norm import channel_norm

# calls of ffn_block that launched the CUDA kernel chain
launches = 0


def norm_film(x: torch.Tensor, film_mul: torch.Tensor,
              film_bias: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """h = T(channel_norm(x) * film_mul + film_bias) on rows [N, C], the
    FiLM product in fp32; film rows [F, C] repeat with period F."""
    n, c = x.shape
    f = film_mul.shape[0]
    hn = channel_norm(x.float(), eps).view(n // f, f, c)
    h = hn * film_mul.float() + film_bias.float()
    return h.reshape(n, c).to(x.dtype)


def reglu_sum_fp32(h, gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc,
                   expert_ids) -> torch.Tensor:
    """fp32 sum of the general and the two selected experts' ReGLUs of
    h [N, C], output biases included (the gate rounded to h.dtype)."""
    ids = expert_ids.long()
    sel = lambda w: w.index_select(0, ids).float()
    ea, eba, eb, ebb, ec, ebc = sel(wa), sel(ba), sel(wb), sel(bb), sel(wc), sel(bc)
    hf = h.float()
    out = gbc.float() + ebc[0] + ebc[1]
    for wa_, ba_, wb_, bb_, wc_ in (
        (gwa.float(), gba.float(), gwb.float(), gbb.float(), gwc.float()),
        (ea[0], eba[0], eb[0], ebb[0], ec[0]),
        (ea[1], eba[1], eb[1], ebb[1], ec[1]),
    ):
        a = hf @ wa_ + ba_
        b = hf @ wb_ + bb_
        g = (a * torch.relu(b)).to(h.dtype)
        out = out + g.float() @ wc_
    return out


def ffn_block_plain(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
                    wa, ba, wb, bb, wc, bc, expert_ids):
    """Plain PyTorch version: x [N, C], film [F, C] with N % F == 0."""
    h = norm_film(x, film_mul, film_bias)
    out = reglu_sum_fp32(h, gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb,
                         wc, bc, expert_ids)
    return out.to(x.dtype), h


def check_ffn_args(x, film_mul, film_bias, weights, expert_ids):
    """Shapes, types and placement the CUDA chain takes; raises otherwise."""
    n, c = x.shape
    gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc = weights
    e, _, m = wa.shape
    want = {
        "film_mul": (film_mul, (film_mul.shape[0], c)),
        "film_bias": (film_bias, film_mul.shape),
        "gwa": (gwa, (c, m)), "gba": (gba, (m,)), "gwb": (gwb, (c, m)),
        "gbb": (gbb, (m,)), "gwc": (gwc, (m, c)), "gbc": (gbc, (c,)),
        "wa": (wa, (e, c, m)), "ba": (ba, (e, m)), "wb": (wb, (e, c, m)),
        "bb": (bb, (e, m)), "wc": (wc, (e, m, c)), "bc": (bc, (e, c)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {x.dtype}")
    if n % film_mul.shape[0]:
        raise ValueError(f"film rows {film_mul.shape[0]} do not divide {n}")
    if expert_ids.dtype != torch.int32 or tuple(expert_ids.shape) != (2,):
        raise TypeError("expert_ids must be int32 [2]")
    return n, c, m, e


def ffn_block(x, film_mul, film_bias, gwa, gba, gwb, gbb, gwc, gbc,
              wa, ba, wb, bb, wc, bc, expert_ids):
    """(out, h), both [N, C]. CPU tensors take the plain version; CUDA
    tensors launch the kernel chain or raise."""
    if x.device.type == "cpu":
        return ffn_block_plain(x, film_mul, film_bias, gwa, gba, gwb, gbb,
                               gwc, gbc, wa, ba, wb, bb, wc, bc, expert_ids)
    weights = (gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc)
    n, c, m, e = check_ffn_args(x, film_mul, film_bias, weights, expert_ids)
    code = _build.dtype_code(x)
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    g = torch.empty((3, n, m), dtype=x.dtype, device=x.device)
    lib = _build.load("ffn_block")
    scratch = torch.empty(lib.ffn_scratch_floats(n, c, m), dtype=torch.float32,
                          device=x.device)
    p = _build.cuda_ptrs(x, film_mul, film_bias, *weights, expert_ids, out,
                         h, g, scratch)
    rc = lib.ffn_block_forward(
        code, p[0], p[1], p[2], film_mul.shape[0], *p[3:15], e, p[15],
        n, c, m, p[16], p[17], p[18], p[19],
        _build.current_stream(),
    )
    _build.check(lib, rc, "ffn_block")
    global launches
    launches += 1
    return out, h
