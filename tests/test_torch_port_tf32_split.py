"""The arithmetic of the port's float32 tensor-core routes (block_core and
window MHA forward, csrc/tf32_common.cuh) against the JAX package on the
CPU.

The routes compute every fp32 product on the H100's tensor cores as three
TF32 passes: each operand is split into a TF32 head hi = rna(v) and tail lo
= rna(v - hi) (cvt.rna.tf32.f32), a product is lo*hi + hi*lo + hi*hi, and
the passes of one k-tile go into a zeroed fp32 partial (the tensor cores
add with truncation) that joins the running sum by a rounded fp32 add.
This file emulates that in plain PyTorch, on each kernel's own tiling
(64-deep k-tiles of the FFN towers, the grouped conv's 32-deep taps, the
window projections' 32-deep tiles, one partial per score and P v product),
and holds the emulated block_core body and window MHA against the JAX
package's functions (fp32 XLA compositions and the Pallas kernels in
interpret mode, as its own tests run them) at 1e-4, the card's fp32 gate.
The deep cases run block_core's output product at the depth of the UNet's
C=1024 stage, 3 x 1024 + 288. The emulation lives here, not in the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.kernels import block_core as jbc
from ldm_image_generator_tpu.kernels import window_attention as jattn
from ldm_image_generator_tpu_torch.kernels.ffn_block import norm_film

torch.set_num_threads(1)

# the card's fp32 gate (chip_smoke.FP32_TOL)
TOL = dict(rtol=1e-4, atol=1e-4)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32):
    the 13 low mantissa bits rounded into the rest of the magnitude."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v: torch.Tensor):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _truncated(d: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 value truncated toward zero (the tensor
    cores' accumulator does not round to nearest), kept in float64."""
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f).double()


def _ktile(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a @ b for one k-tile (a [..., m, k], b [..., k, n], k a
    multiple of 8), as warp_mma_f32 sums it: per m16n8k8 step the three
    passes (tail*head, head*tail, head*head), each an exact sum of 8
    products added into a zeroed fp32 partial with truncation; then the
    partial joins acc by an fp32 add, rounded to nearest."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    part = torch.zeros(acc.shape, dtype=torch.float64)
    for s in range(0, a.shape[-1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = _truncated(part + x[..., s:s + 8].double() @ y[..., s:s + 8, :].double())
    return acc + part.float()


def _product(a: torch.Tensor, b: torch.Tensor, kt: int) -> torch.Tensor:
    """a @ b over k-tiles of kt (fp32 result)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], kt):
        acc = _ktile(acc, a[..., k0:k0 + kt], b[..., k0:k0 + kt, :])
    return acc


def _block_core_tc(x, mul, bias, w, ck, cb, ids, add_residual):
    """block_core's fp32 route (ffn_tf32_fwd.cuh): h as norm_film; per
    tower g = (h @ wa + ba) * relu(h @ wb + bb) over 64-deep k-tiles; one
    output sum over the towers' 64-deep k-tiles of [g_0 | g_1 | g_2] @
    [wc_0; wc_1; wc_2], then the 9 conv taps (per 32-channel group a
    32-deep k-tile of h shifted by the tap), then the biases and the
    residual."""
    b, hh, ww, c = x.shape
    gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc = w
    h = norm_film(x.reshape(-1, c), mul.reshape(-1, c), bias.reshape(-1, c))
    towers = [(gwa, gba, gwb, gbb, gwc, gbc)] + [
        (wa[e], ba[e], wb[e], bb[e], wc[e], bc[e]) for e in ids]
    out = torch.zeros_like(h)
    for t_wa, t_ba, t_wb, t_bb, t_wc, _ in towers:
        g = (_product(h, t_wa, 64) + t_ba) * torch.relu(_product(h, t_wb, 64) + t_bb)
        for k0 in range(0, g.shape[-1], 64):
            out = _ktile(out, g[:, k0:k0 + 64], t_wc[k0:k0 + 64])
    hp = torch.nn.functional.pad(h.reshape(b, hh, ww, c), (0, 0, 1, 1, 1, 1))
    gw = ck.shape[2]
    for ky in range(3):
        for kx in range(3):
            shifted = hp[:, ky:ky + hh, kx:kx + ww].reshape(-1, c)
            for g0 in range(0, c, gw):
                cols = slice(g0, g0 + gw)
                out[:, cols] = _ktile(out[:, cols], shifted[:, cols], ck[ky, kx, :, cols])
    out = out + (gbc + towers[1][5] + towers[2][5] + cb)
    if add_residual:
        out = out + x.reshape(-1, c)
    return out.reshape(x.shape), h.reshape(x.shape)


def _window_mha_tc(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, heads):
    """window MHA's fp32 forward (namespace wtf): q, k, v over 32-deep
    k-tiles; per (window, head) the scores in one partial (d deep), the
    fp32 softmax, P v in one partial (the window's keys, zero-padded to a
    multiple of 16 as the kernel's m-tiles are); the output projection
    over 64-deep k-tiles."""
    n, l, c = x.shape
    d = c // heads
    x2 = x.reshape(n * l, c)
    split_heads = lambda t: t.reshape(n, l, heads, d).transpose(1, 2)
    q, k, v = (split_heads(_product(x2, w_, 32) + b_)
               for w_, b_ in ((wq, bq), (wk, bk), (wv, bv)))
    scores = _ktile(torch.zeros((n, heads, l, l)), q, k.transpose(-1, -2))
    scores = scores * (1.0 / float(d) ** 0.5)
    if mask is not None:
        scores = scores + torch.where(mask[:, None, None, :], -1e9, 0.0)
    p = torch.softmax(scores, dim=-1)
    keys = -(-l // 16) * 16
    o = _ktile(torch.zeros((n, heads, l, d)),
               torch.nn.functional.pad(p, (0, keys - l)),
               torch.nn.functional.pad(v, (0, 0, 0, keys - l)))
    o = o.transpose(1, 2).reshape(n * l, c)
    return (_product(o, wo, 64) + bo).reshape(n, l, c)


def _block_case(b, hw, c, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=0.05: (rng.normal(size=s) * scale).astype(np.float32)
    x = r(b, hw, hw, c, scale=1.0)
    mul = r(1, hw, hw, c, scale=0.2) + 1.0
    bias = r(1, hw, hw, c, scale=0.2)
    w = (r(c, c), r(c), r(c, c), r(c), r(c, c), r(c),
         r(4, c, c), r(4, c), r(4, c, c), r(4, c), r(4, c, c), r(4, c))
    ck, cb = r(3, 3, 32, c, scale=0.1), r(c, scale=0.1)
    return x, mul, bias, w, ck, cb


def _attn_case(n, l, c, seed, masked):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, l, c)).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32) for s in [(c, c), (c,)] * 4]
    mask = None
    if masked:
        mask = np.zeros((n, l), bool)
        mask[:, l - 6:] = True  # padded keys, as a window over the map's edge
        mask[0, :] = False
    return x, mask, ws


# (kernel, shape, whether the Pallas kernel runs too): block_core (B, map
# side, C), window MHA (windows, tokens, C, heads, masked). The last of
# each is the deep case: block_core's C=1024 stage (output product 3360
# deep), window MHA's C=1024 map of 16 tokens (projections 1024 deep)
CASES = [
    ("block_core", (1, 8, 128), True),
    ("block_core", (2, 4, 256), False),
    ("block_core", (1, 4, 1024), False),
    ("window_mha", (3, 36, 128, 4, True), True),
    ("window_mha", (4, 36, 256, 8, True), False),
    ("window_mha", (1, 16, 1024, 32, False), False),
]


@pytest.mark.parametrize("kernel,shape,pallas", CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s, _ in CASES])
def test_tf32_route_arithmetic_matches_jax(kernel, shape, pallas):
    """The emulated route against the JAX package's fp32 function at 1e-4
    (and against its Pallas kernel in interpret mode where `pallas`)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if kernel == "block_core":
        x, mul, bias, w, ck, cb = _block_case(*shape, seed=sum(shape))
        ids = (1, 3)
        out, h = _block_core_tc(t(x), t(mul), t(bias), [t(a) for a in w], t(ck), t(cb),
                                ids, add_residual=True)
        args = [jnp.asarray(a) for a in (x, mul, bias, *w, ck, cb)]
        refs = [jbc.block_core_xla(*args, *ids)]
        if pallas:
            refs.append(jbc.block_core_pallas(*args, jnp.asarray(ids, jnp.int32),
                                              interpret=True))
        for ref_out, ref_h in refs:
            np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    else:
        n, l, c, heads, masked = shape
        x, mask, ws = _attn_case(n, l, c, seed=n + l + c, masked=masked)
        out = _window_mha_tc(t(x), None if mask is None else t(mask), *map(t, ws), heads)
        m = None if mask is None else jnp.asarray(mask)
        args = [jnp.asarray(a) for a in ws]
        refs = [jattn.window_mha_xla(jnp.asarray(x), m, *args, heads)]
        if pallas:
            refs.append(jattn.window_mha_pallas(jnp.asarray(x), m, *args, num_heads=heads,
                                                interpret=True))
        for ref in refs:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
