"""Windowed multi-head self-attention over [N, L, C] token windows.

Replaces ``window_mha_pallas`` (ldm_image_generator_tpu/kernels/
window_attention.py:188), forward only:

    q, k, v = T(x @ wq + bq), T(x @ wk + bk), T(x @ wv + bv)
    p       = T(softmax(q k^T / sqrt(d) - 1e9 * key_pad))   (fp32 scores)
    out     = T(T(p v) @ wo + bo)

On the H100 (csrc/window_attention.cu): at the sampling shapes (36-token
windows, or one 16-token map at C=1024) the call is bound by bytes, the
four C x C projection weights; the scores are tiny (L x L per head). The
design is three steps: one projection pass reading wq, wk and wv in
place, one block per (window, head) that keeps q, k, v, the scores and
the probabilities in shared memory (no online softmax is needed at
L <= 64), and the output projection. At few rows the projections split
k over blocks (with an elementwise pass summing the fp32 partials), as
ffn_block does. The TPU kernel's head folding is a
Mosaic workaround and is not carried over.
"""
from __future__ import annotations

import torch

from ldm_image_generator_tpu_torch.kernels import _build

NEG_INF = -1e9

# calls of window_mha that launched the CUDA kernel chain
launches = 0


def window_mha_plain(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
                     num_heads: int):
    """Plain PyTorch version. x: [N, L, C]; mask: [N, L] bool (True =
    padded key) or None."""
    n, l, c = x.shape
    h = num_heads
    d = c // h
    dt = x.dtype
    xf = x.float()
    proj = lambda w, b: (xf @ w.float() + b.float()).to(dt)
    q = proj(wq, bq).reshape(n, l, h, d).float()
    k = proj(wk, bk).reshape(n, l, h, d).float()
    v = proj(wv, bv).reshape(n, l, h, d).float()
    scores = torch.einsum("nlhd,nshd->nhls", q, k)
    scores = scores * (1.0 / torch.sqrt(torch.tensor(float(d))))
    if mask is not None:
        scores = scores + torch.where(mask[:, None, None, :], NEG_INF, 0.0)
    probs = torch.softmax(scores, dim=-1).to(dt).float()
    o = torch.einsum("nhls,nshd->nlhd", probs, v).reshape(n, l, c).to(dt)
    return (o.float() @ wo.float() + bo.float()).to(dt)


def window_mha(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int):
    """[N, L, C] attention output. CPU tensors take the plain version;
    CUDA tensors launch the kernel chain or raise."""
    if x.device.type == "cpu":
        return window_mha_plain(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                num_heads)
    n, l, c = x.shape
    if c % num_heads:
        raise ValueError(f"C={c} is not a multiple of {num_heads} heads")
    for name, t, shape in (("wq", wq, (c, c)), ("wk", wk, (c, c)),
                           ("wv", wv, (c, c)), ("wo", wo, (c, c)),
                           ("bq", bq, (c,)), ("bk", bk, (c,)),
                           ("bv", bv, (c,)), ("bo", bo, (c,))):
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want "
                             f"{shape} {x.dtype}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (n, l)):
        raise ValueError(f"mask must be bool [{n}, {l}]")
    code = _build.dtype_code(x)
    lib = _build.load("window_attention")
    smem = lib.window_mha_smem_bytes(l, c // num_heads)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"L={l}, d={c // num_heads} needs {smem} bytes of "
                         "shared memory per block")
    qkv = torch.empty((n, l, 3 * c), dtype=x.dtype, device=x.device)
    o = torch.empty_like(x)
    out = torch.empty_like(x)
    scratch = torch.empty(lib.window_mha_scratch_floats(n, l, c),
                          dtype=torch.float32, device=x.device)
    p = _build.cuda_ptrs(x, wq, bq, wk, bk, wv, bv, wo, bo, qkv, o, out,
                         scratch)
    mask_ptr = None if mask is None else _build.cuda_ptrs(mask)[0]
    rc = lib.window_mha_forward(
        code, p[0], mask_ptr, *p[1:9], n, l, c, num_heads, p[9], p[10],
        p[11], p[12], _build.current_stream(),
    )
    _build.check(lib, rc, "window_mha")
    global launches
    launches += 1
    return out
