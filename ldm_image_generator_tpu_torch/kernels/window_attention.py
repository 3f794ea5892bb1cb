"""Windowed multi-head self-attention over [N, L, C] token windows.

Replaces ``window_mha_pallas`` (ldm_image_generator_tpu/kernels/
window_attention.py:188) and, for gradients, ``window_mha_bwd_pallas``
(:402):

    q, k, v = T(x @ wq + bq), T(x @ wk + bk), T(x @ wv + bv)
    p       = T(softmax(q k^T / sqrt(d) - 1e9 * key_pad))   (fp32 scores)
    out     = T(T(p v) @ wo + bo)

On the H100 (csrc/window_attention.cu). What bounds a call: at the
sampling shapes (36-token windows, or one 16-token map at C=1024),
latency: the chain of dependent launches, the first bytes of the four
C x C weights (0.1-8 MB) and a window's serial softmax; the scores are
tiny (L x L per head, no online softmax needed at L <= 64). At the B=8
training shapes, the projections' products.

bfloat16 runs every product on the tensor cores (mma.sync m16n8k16,
fp32 accumulators, csrc/mma_common.cuh) in two launches each way:
  forward: one CTA per (window, head) projects the window onto the
    head's q, k, v columns (weights read in place through a ring of
    cp.async stages) and runs the attention in shared memory; at batch 1
    and C >= 256, where that gives fewer CTAs than SMs, a cluster of
    three CTAs splits each head by projection. Then the output
    projection, launched to overlap the first kernel's end, with k split
    over blocks at few rows and the splits summed by the last block to
    arrive, in a fixed order;
  backward: one CTA per (window, head) recomputes q, k, v, projects
    dO = T(g wo^T) for its head and forms o, dv, dS, dq, dk; then one
    launch holding dx = T(dqkv [wq|wk|wv]^T) (rounded once) and the four
    fp32 weight gradients (bias gradients as column sums), split over
    the rows and summed in a fixed order, so reruns are bitwise equal.
  It takes head dim 32 and L <= 64 (every shape of the UNet); other
  bfloat16 shapes take the FMA path below, chosen by shape alone.
float32 runs the same two launches each way on the tensor cores at the
same shapes, each product as three TF32 passes (csrc/tf32_common.cuh),
fp32 accurate: it holds the fp32 gates (kernel vs plain at 1e-4, card vs
CPU); the softmax and its backward stay fp32 on the CUDA cores, and the
backward keeps P and dS in fp32 shared memory for its transposed
products. Both types at other shapes keep the CUDA-core FMA path: a qkv
projection, one block per (window, head) holding q, k, v and the scores
in fp32 shared memory, and the output projection (k split over blocks at
few rows, with a summing pass); the backward recomputes qkv, dO, the
per-head gradients, dx and the weight gradients in a chain of such
passes. The TPU kernel's head folding is a Mosaic workaround and is
not carried over. ``window_mha`` is an autograd Function around both
directions; the JAX package kept C=1024 on its XLA VJP (a Mosaic
limit), the port has no such cap.
"""
from __future__ import annotations

import torch

from ldm_image_generator_tpu_torch.kernels import _build

NEG_INF = -1e9

# calls of window_mha and of window_mha_bwd that launched their CUDA chains
launches = 0
bwd_launches = 0


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


def _check_mha_args(x, mask, weights, num_heads):
    n, l, c = x.shape
    if c % num_heads:
        raise ValueError(f"C={c} is not a multiple of {num_heads} heads")
    for name, t in zip(("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"),
                       weights):
        shape = (c, c) if name[0] == "w" else (c,)
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want "
                             f"{shape} {x.dtype}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (n, l)):
        raise ValueError(f"mask must be bool [{n}, {l}]")


def _check_smem(smem: int, l: int, d: int, what: str) -> None:
    """Raise when a block of the kernel cannot take (L, d)."""
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"L={l}, d={d} needs {smem} bytes of shared memory "
                         f"per{what} block")


# {device index: int32 split-K counters}: zero before a tensor-core call,
# left zero by it (the last block of each split tile resets its counter)
_counters: dict = {}


def _split_counters(lib, device) -> torch.Tensor:
    t = _counters.get(device.index)
    if t is None:
        t = torch.zeros(lib.window_mha_counter_ints(), dtype=torch.int32,
                        device=device)
        _counters[device.index] = t
    return t


def _window_mha_forward(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
                        num_heads: int):
    """The plain version for CPU tensors, the kernel chain for CUDA
    tensors (or an exception)."""
    if x.device.type == "cpu":
        return window_mha_plain(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                num_heads)
    _check_mha_args(x, mask, (wq, bq, wk, bk, wv, bv, wo, bo), num_heads)
    n, l, c = x.shape
    code = _build.dtype_code(x)
    lib = _build.load("window_attention")
    _check_smem(lib.window_mha_smem_bytes(code, l, c, num_heads), l,
                c // num_heads, "")
    # qkv: the FMA route's projection output (the tensor-core routes keep
    # q, k, v of a head in shared memory)
    tc = lib.window_mha_tensor_cores(code, l, c, num_heads)
    qkv = torch.empty((0,) if tc else (n, l, 3 * c), dtype=x.dtype,
                      device=x.device)
    o = torch.empty_like(x)
    out = torch.empty_like(x)
    scratch = torch.empty(lib.window_mha_scratch_floats(code, n, l, c,
                                                        num_heads),
                          dtype=torch.float32, device=x.device)
    p = _build.cuda_ptrs(x, wq, bq, wk, bk, wv, bv, wo, bo, qkv, o, out,
                         scratch, _split_counters(lib, x.device))
    mask_ptr = None if mask is None else _build.cuda_ptrs(mask)[0]
    rc = lib.window_mha_forward(
        code, p[0], mask_ptr, *p[1:9], n, l, c, num_heads, *p[9:],
        _build.current_stream(),
    )
    _build.check(lib, rc, "window_mha")
    global launches
    launches += 1
    return out


def window_mha_bwd_plain(x, mask, g, wq, bq, wk, bk, wv, bv, wo, bo,
                         num_heads: int):
    """Plain PyTorch version of the backward, the per-head math of
    window_mha_bwd_pallas. g: the out-cotangent [N, L, C]. Returns (dx in
    x.dtype, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo in fp32). Rounded to
    x.dtype as the TPU kernel rounds: the qkv recompute, dO, the
    probabilities used for dv (fp32 ones for dS), dS, dq, dk, dv and dx
    (one rounding of an fp32 product)."""
    n, l, c = x.shape
    h = num_heads
    d = c // h
    dt = x.dtype
    scale = 1.0 / float(d) ** 0.5
    rnd = lambda t: t.to(dt).float()
    x2 = x.reshape(n * l, c).float()
    g2 = g.reshape(n * l, c).to(dt).float()
    heads = lambda t: t.reshape(n, l, h, d)
    proj = lambda w, b: heads(rnd(x2 @ w.float() + b.float()))
    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    dout = heads(rnd(g2 @ wo.float().t()))
    scores = torch.einsum("nlhd,nshd->nhls", q, k) * scale
    if mask is not None:
        scores = scores + torch.where(mask[:, None, None, :], NEG_INF, 0.0)
    probs32 = torch.softmax(scores, dim=-1)
    probs = rnd(probs32)
    out = rnd(torch.einsum("nhls,nshd->nlhd", probs, v)).reshape(n * l, c)
    dprobs = torch.einsum("nlhd,nshd->nhls", dout, v)
    dv = rnd(torch.einsum("nhls,nlhd->nshd", probs, dout))
    ds = probs32 * (dprobs - (dprobs * probs32).sum(-1, keepdim=True))
    dsb = rnd(ds * scale)
    dq = rnd(torch.einsum("nhls,nshd->nlhd", dsb, k))
    dk = rnd(torch.einsum("nhls,nlhd->nshd", dsb, q))
    dqkv = torch.cat([t.reshape(n * l, c) for t in (dq, dk, dv)], dim=-1)
    wqkv = torch.cat([wq, wk, wv], dim=1).float()
    dx = (dqkv @ wqkv.t()).to(dt).reshape(n, l, c)
    dwqkv = x2.t() @ dqkv
    dbqkv = dqkv.sum(0)
    return (dx, dwqkv[:, :c], dbqkv[:c], dwqkv[:, c:2 * c], dbqkv[c:2 * c],
            dwqkv[:, 2 * c:], dbqkv[2 * c:], out.t() @ g2, g2.sum(0))


def window_mha_bwd(x, mask, g, wq, bq, wk, bk, wv, bv, wo, bo,
                   num_heads: int):
    """The backward (see window_mha_bwd_plain for what it returns). CPU
    tensors take the plain version; CUDA tensors launch the kernel chain
    or raise."""
    if x.device.type == "cpu":
        return window_mha_bwd_plain(x, mask, g, wq, bq, wk, bk, wv, bv, wo,
                                    bo, num_heads)
    _check_mha_args(x, mask, (wq, bq, wk, bk, wv, bv, wo, bo), num_heads)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g: {tuple(g.shape)} {g.dtype}, want "
                         f"{tuple(x.shape)} {x.dtype}")
    n, l, c = x.shape
    code = _build.dtype_code(x)
    lib = _build.load("window_attention")
    _check_smem(lib.window_mha_bwd_smem_bytes(code, l, c, num_heads), l,
                c // num_heads, " backward")
    like = dict(dtype=x.dtype, device=x.device)
    # qkv and dO: the FMA route's intermediates (the tensor-core route
    # keeps a head's q, k, v and dO in shared memory)
    tc = lib.window_mha_bwd_tensor_cores(code, l, c, num_heads)
    dx = torch.empty_like(x)
    qkv = torch.empty((0,) if tc else (n, l, 3 * c), **like)
    o = torch.empty_like(x)
    dout = torch.empty((0,) if tc else tuple(x.shape), **like)
    dqkv = torch.empty((n, l, 3 * c), **like)
    grads = torch.empty(4 * (c + 1) * c, dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.window_mha_bwd_scratch_floats(code, n, l, c,
                                                            num_heads),
                          dtype=torch.float32, device=x.device)
    p = _build.cuda_ptrs(x, g, wq, bq, wk, bk, wv, bv, wo, dx, qkv, o, dout,
                         dqkv, grads, scratch, _split_counters(lib, x.device))
    mask_ptr = None if mask is None else _build.cuda_ptrs(mask)[0]
    rc = lib.window_mha_backward(code, p[0], mask_ptr, *p[1:9], n, l, c,
                                 num_heads, *p[9:], _build.current_stream())
    _build.check(lib, rc, "window_mha_bwd")
    global bwd_launches
    bwd_launches += 1
    out = [dx]
    cc = c * c
    for z in range(4):
        t = grads[z * (cc + c):(z + 1) * (cc + c)]
        out += [t[:cc].view(c, c), t[cc:]]
    return tuple(out)


class _WindowMHA(torch.autograd.Function):
    """window_mha with its backward (the JAX package's custom_vjp
    fused_window_mha with window_mha_bwd_pallas)."""

    @staticmethod
    def forward(ctx, x, mask, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, mask, wq, bq, wk, bk, wv, bv, wo, bo)
        return _window_mha_forward(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
                                   num_heads)

    @staticmethod
    def backward(ctx, g):
        x, mask, *weights = ctx.saved_tensors
        grads = window_mha_bwd(x, mask, g.to(x.dtype).contiguous(), *weights,
                               num_heads=ctx.num_heads)
        dw = [gr.to(w.dtype) for gr, w in zip(grads[1:], weights)]
        return (grads[0], None, *dw, None)


def window_mha(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int):
    """[N, L, C] attention output, differentiable in x and the weights.
    CPU tensors take the plain versions; CUDA tensors launch the kernel
    chains (forward and backward) or raise. Grad mode off skips the
    autograd Function (see ffn_block)."""
    fn = _WindowMHA.apply if torch.is_grad_enabled() else _window_mha_forward
    return fn(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)
