"""The arithmetic of the port's float32 tensor-core routes (block_core and
ffn_block with fp32 and with int8 FFN weights, window MHA forward and
backward, ffn_block's backward; csrc/tf32_common.cuh) against the JAX
package on the CPU.

The routes compute every fp32 product on the H100's tensor cores as three
TF32 passes: each operand is split into a TF32 head hi = rna(v) and tail lo
= rna(v - hi) (cvt.rna.tf32.f32), a product is lo*hi + hi*lo + hi*hi, and
the passes of one k-tile go into a zeroed fp32 partial (the tensor cores
add with truncation) that joins the running sum by a rounded fp32 add.
This file emulates that in plain PyTorch, on each kernel's own tiling
(64-deep k-tiles of the FFN towers, the grouped conv's 32-deep taps, the
window projections' 32-deep tiles, one partial per score and P v product;
in the backward kernels the weight gradients' 64-row k-tiles split over
blocks as the H100's 132 SMs make the plans split them, the fp32 column
sums of the bias gradients in the kernels' order, dh and dx over their
64-deep k-tiles), and holds the emulated kernels against the JAX
package's functions (fp32 XLA compositions and their VJPs, and the Pallas
kernels in interpret mode, as its own tests run them) at 1e-4, the card's
fp32 gate. The deep cases run block_core's output product at the depth of
the UNet's C=1024 stage, 3 x 1024 + 288, ffn_block's dh at 6M = 6144 deep
at C = M = 1024, and the backward kernels' weight gradients over 4096 and
more rows. With int8 FFN weights (ffn_tf32_fwd.cuh, Q) an int8 value is
exact in TF32, so a tower product is two passes, lo(a) q + hi(a) q; the
gate gives a and b their column scale and bias (one rounding), and the
output product scales each tower's sum at its last k-tile of a split,
the splits (as the H100's plans split k) meeting already scaled. The
emulation lives here, not in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ldm_image_generator_tpu.kernels import block_core as jbc
from ldm_image_generator_tpu.kernels import ffn_block as jffn
from ldm_image_generator_tpu.kernels import window_attention as jattn
from ldm_image_generator_tpu_torch.kernels import workloads
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


# the 29 low mantissa bits a float64 has beyond a float32's 23
_BELOW_FP32 = ~((1 << 29) - 1)


def _truncated(d: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 value truncated toward zero (the tensor
    cores' accumulator does not round to nearest), kept in float64: the
    mantissa bits below float32's cleared (exact for values in float32's
    normal range, as every partial here is)."""
    return (d.view(torch.int64) & _BELOW_FP32).view(torch.float64)


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


# ---------------------------------------------------------------------------
# The backward routes (ffn_tf32_bwd.cuh, window_attention.cu namespace wtf)

SMS = 132  # the H100's streaming multiprocessors, by which the tail plans split


def _split_per(tiles: int, kt: int) -> int:
    """k-tiles per split of a tail launch's product (ffn_tc.cuh split_k and
    wtc::tail_plan alike): the k-tiles split over blocks until the grid has
    two blocks per SM, at least 4 k-tiles each."""
    s = 1
    if tiles < 2 * SMS:
        s = max(1, min(-(-2 * SMS // tiles), kt // 4))
    return -(-kt // s)


def _product_split(a: torch.Tensor, b: torch.Tensor, per: int) -> torch.Tensor:
    """a @ b over 64-deep k-tiles, `per` k-tiles a split: each split sums
    from zero, and the splits meet in order (split_fixup) by fp32 adds."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 64 * per):
        acc = acc + _product(a[..., k0:k0 + 64 * per], b[k0:k0 + 64 * per], 64)
    return acc


def _col_sums(b: torch.Tensor, per: int) -> torch.Tensor:
    """The bias gradient of a tail block: b's columns summed in fp32 as the
    kernel sums them. Per split, thread t < 64 adds rows 0-31 of each landed
    64-row k-tile, thread t + 64 rows 32-63, one row at a time; the splits'
    sums meet in order; then the two halves."""
    rows, ncol = b.shape
    kt = -(-rows // 64)
    tiles = F.pad(b, (0, 0, 0, kt * 64 - rows)).reshape(kt, 64, ncol)
    halves = []
    for half in (0, 1):
        total = torch.zeros(ncol)
        for s0 in range(0, kt, per):
            cs = torch.zeros(ncol)
            for t in range(s0, min(kt, s0 + per)):
                for r in range(32):
                    cs = cs + tiles[t, 32 * half + r]
            total = total + cs
        halves.append(total)
    return halves[0] + halves[1]


def _ffn_bwd_tc(h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc, ids):
    """ffn_block's fp32 backward route: per tower a, b over 64-deep k-tiles
    of C and dg = g wc^T likewise (split over blocks as the gate's plan
    splits them where its grid is small), then da, db and the gate in fp32; the
    nine weight gradients over 64-row k-tiles split as the tail plan splits
    them, bias gradients as the kernel's column sums; dh one product over
    the six segments [da_0 | db_0 | da_1 | ...] @ [wa_0^T; wb_0^T; ...],
    split likewise. Returns (dh, then per tower dwa, dba, dwb, dbb, dwc)."""
    n, c = h.shape
    m = gwa.shape[1]
    gate_per = _split_per((m // 64) * -(-n // 64) * 3, c // 64)
    dw_per = _split_per(9 * (c // 64) * (m // 64), -(-n // 64))
    dh_per = _split_per(-(-n // 64) * (c // 64), 6 * m // 64)
    towers = [(gwa, gba, gwb, gbb, gwc)] + [
        (wa[e], ba[e], wb[e], bb[e], wc[e]) for e in ids]
    grads, seg_a, seg_b = [], [], []
    for t_wa, t_ba, t_wb, t_bb, t_wc in towers:
        a = _product_split(h, t_wa, gate_per) + t_ba
        b = _product_split(h, t_wb, gate_per) + t_bb
        dg = _product_split(g, t_wc.t(), gate_per)
        relu_b = torch.clamp_min(b, 0.0)
        da, db, gate = dg * relu_b, dg * a * (b > 0), a * relu_b
        grads += [_product_split(h.t(), da, dw_per), _col_sums(da, dw_per),
                  _product_split(h.t(), db, dw_per), _col_sums(db, dw_per),
                  _product_split(gate.t(), g, dw_per)]
        seg_a += [da, db]
        seg_b += [t_wa.t(), t_wb.t()]
    dh = _product_split(torch.cat(seg_a, 1), torch.cat(seg_b, 0), dh_per)
    return (dh, *grads)


def _window_mha_bwd_tc(x, mask, g, wq, bq, wk, bk, wv, bv, wo, bo, heads):
    """window MHA's fp32 backward route (wtf::bwd_core_kernel, bwd_tail_kernel):
    q, k, v and dO = g wo^T over 32-deep k-tiles; per (window, head) the
    scores and dP = dO v^T in one partial each (d deep), the fp32 softmax
    and dS = P (dP - rowsum(dP P)) scale, o = P v, dq = dS k, dv = P^T dO,
    dk = dS^T q in one partial each (the keys or queries zero-padded to a
    multiple of 16, as the kernel's m-tiles are); then dx = dqkv [wq | wk |
    wv]^T over 64-deep k-tiles of 3C, at most 8 a split, and the weight
    gradients x^T [dq | dk | dv], o^T g over 64-row k-tiles split as the
    tail plan splits them, bias gradients as the kernel's column sums.
    Returns (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)."""
    n, l, c = x.shape
    d = c // heads
    rows, keys = n * l, -(-l // 16) * 16
    scale = 1.0 / float(d) ** 0.5
    x2, g2 = x.reshape(rows, c), g.reshape(rows, c)
    split_heads = lambda t: t.reshape(n, l, heads, d).transpose(1, 2)
    merge = lambda t: t.transpose(1, 2).reshape(rows, c)
    pad_keys = lambda t: F.pad(t, (0, keys - l))         # [..., l, keys]
    pad_rows = lambda t: F.pad(t, (0, 0, 0, keys - l))   # [..., keys, d]
    q, k, v = (split_heads(_product(x2, w_, 32) + b_)
               for w_, b_ in ((wq, bq), (wk, bk), (wv, bv)))
    do = split_heads(_product(g2, wo.t(), 32))
    zeros = lambda *s: torch.zeros((n, heads) + s)
    scores = _ktile(zeros(l, l), q, k.transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + torch.where(mask[:, None, None, :], -1e9, 0.0)
    p = torch.softmax(scores, dim=-1)
    o = _ktile(zeros(l, d), pad_keys(p), pad_rows(v))
    dp = _ktile(zeros(l, l), do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = _ktile(zeros(l, d), pad_keys(ds), pad_rows(k))
    dv = _ktile(zeros(l, d), pad_keys(p.transpose(-1, -2)), pad_rows(do))
    dk = _ktile(zeros(l, d), pad_keys(ds.transpose(-1, -2)), pad_rows(q))
    dqkv = torch.cat([merge(t) for t in (dq, dk, dv)], 1)
    tn = -(-c // 64)
    dw_per = _split_per(4 * tn * tn, -(-rows // 64))
    dx = _product_split(dqkv, torch.cat([wq, wk, wv], 1).t(), min(-(-3 * c // 64), 8))
    out = [dx.reshape(n, l, c)]
    for a_, b_ in [(x2, dqkv[:, z * c:(z + 1) * c]) for z in range(3)] + [(merge(o), g2)]:
        out += [_product_split(a_.t(), b_, dw_per), _col_sums(b_, dw_per)]
    return tuple(out)


# (kernel, shape, whether the Pallas kernel runs too): ffn_block_bwd (rows,
# C, M), window MHA backward (windows, tokens, C, heads, masked). The deep
# cases: the weight gradients over 4096 rows (ffn, the first stage's
# widths) and 4356 (window MHA at a 512px B=1 step's first stage: 121
# masked windows of 36 tokens); ffn's dh at 6M = 6144 deep at C = M = 1024;
# window MHA's dx at 3C = 3072 deep on the C=1024 map of 16 tokens
BWD_CASES = [
    ("ffn_block_bwd", (40, 128, 128), True),
    ("ffn_block_bwd", (4096, 128, 128), False),
    ("ffn_block_bwd", (64, 1024, 1024), False),
    ("window_mha_bwd", (3, 36, 128, 4, True), True),
    ("window_mha_bwd", (121, 36, 128, 4, True), False),
    ("window_mha_bwd", (2, 16, 1024, 32, False), False),
]


@pytest.mark.parametrize("kernel,shape,pallas", BWD_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s, _ in BWD_CASES])
def test_tf32_backward_route_arithmetic_matches_jax(kernel, shape, pallas):
    """The emulated backward route against jax.vjp of the JAX package's
    fp32 XLA function at 1e-4 (and against its Pallas backward kernel in
    interpret mode where `pallas`). ffn_block's towers are compared
    through ffn_block_xla's VJP with a FiLM row per row, whose film_bias
    cotangent is dh."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if kernel == "ffn_block_bwd":
        rows, c, m = shape
        rng = np.random.default_rng(rows + c)
        r = lambda *s, scale=0.05: (rng.normal(size=s) * scale).astype(np.float32)
        x, g = r(rows, c, scale=1.0), r(rows, c, scale=1.0)
        mul, bias = r(rows, c, scale=0.2) + 1.0, r(rows, c, scale=0.2)
        w = [r(c, m), r(m), r(c, m), r(m), r(m, c), r(c),
             r(4, c, m), r(4, m), r(4, c, m), r(4, m), r(4, m, c), r(4, c)]
        ids = (1, 3)
        (_, h), vjp = jax.vjp(lambda *a: jffn.ffn_block_xla(*a, *ids),
                              *[jnp.asarray(a) for a in (x, mul, bias, *w)])
        ref = vjp((jnp.asarray(g), jnp.zeros_like(h)))
        # dh, then per tower dwa, dba, dwb, dbb, dwc: the general's, then
        # the stacked experts' rows at the ids
        want = [ref[2]] + list(ref[3:8]) + [
            np.asarray(ref[9 + j])[e] for e in ids for j in (0, 1, 2, 3, 4)]
        tw = [t(a) for k, a in enumerate(w) if k not in (5, 11)]  # no output biases
        got = _ffn_bwd_tc(t(np.asarray(h)), t(g), *tw, ids)
        refs = [want]
        if pallas:
            jw = [jnp.asarray(a) for k, a in enumerate(w) if k not in (5, 11)]
            out = jffn.ffn_block_bwd_pallas(h, jnp.asarray(g), *jw,
                                            jnp.asarray(ids, jnp.int32), interpret=True)
            refs.append([np.asarray(o).reshape(tuple(gt.shape)) for o, gt in zip(out, got)])
    else:
        n, l, c, heads, masked = shape
        x, mask, ws = _attn_case(n, l, c, seed=n + l + c, masked=masked)
        g = np.random.default_rng(n * l).normal(size=(n, l, c)).astype(np.float32)
        got = _window_mha_bwd_tc(t(x), None if mask is None else t(mask), t(g),
                                 *map(t, ws), heads)
        m = None if mask is None else jnp.asarray(mask)
        _, vjp = jax.vjp(lambda x_, *w_: jattn.window_mha_xla(x_, m, *w_, heads),
                         jnp.asarray(x), *[jnp.asarray(a) for a in ws])
        refs = [vjp(jnp.asarray(g))]
        if pallas:
            dx, dwqkv, dbqkv, dwo, dbo = jattn.window_mha_bwd_pallas(
                jnp.asarray(x), m, jnp.asarray(g), *[jnp.asarray(a) for a in ws],
                num_heads=heads, interpret=True)
            dwqkv, dbqkv = np.asarray(dwqkv), np.asarray(dbqkv)
            refs.append([dx] + [a for z in range(3) for a in
                                (dwqkv[:, z * c:(z + 1) * c], dbqkv[z * c:(z + 1) * c])]
                        + [dwo, dbo])
    for ref in refs:
        assert len(ref) == len(got)
        for i, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=str(i), **TOL)


# ---------------------------------------------------------------------------
# The forward routes of ffn_tf32_fwd.cuh with their split-K plans: ffn_block
# in fp32 (three passes, no conv) and block_core and ffn_block with int8 FFN
# weights (two passes on the towers, three on the conv)


def _ktile_q(acc: torch.Tensor, a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """acc + a @ q for one k-tile, q int8 values (exact in TF32), as
    warp_mma_f32q sums it: per m16n8k8 step the two passes (tail*q,
    head*q) into a zeroed partial with truncation, then one rounded fp32
    add into acc."""
    ah, al = _split(a)
    qd = q.double()
    part = torch.zeros(acc.shape, dtype=torch.float64)
    for s in range(0, a.shape[-1], 8):
        for x in (al, ah):
            part = _truncated(part + x[..., s:s + 8].double() @ qd[s:s + 8])
    return acc + part.float()


def _fma(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fmaf(y, scale, bias): the product and the sum rounded once to fp32."""
    return (y.double() * scale.double() + bias.double()).float()


def _ffn_fwd_tc(x, mul, bias, towers, q, conv=None, hw=None):
    """ffn_block's (conv None) or block_core's forward route on rows x [N, C]
    (film rows [N, C]): towers = [(wa, ba, wb, bb, wc, bc)] x 3, with q
    their matrices int8 values (float tensors) and their biases [2, out]
    rows [scale; bias]. Gate and output products over 64-deep k-tiles,
    split over blocks as fwd_plan splits them on 132 SMs; with q each
    tower's output sum scaled at its last k-tile of a split. conv: (taps
    [3, 3, 32, C], bias [C]) on the maps (B, H, W) = hw, after the towers'
    k-tiles, as 9 more k-tiles. Returns (out without the residual, h)."""
    n, c = x.shape
    m = towers[0][0].shape[1]
    h = norm_film(x, mul, bias)
    rt = -(-n // 64)
    ktile = _ktile_q if q else _ktile
    gate_per = _split_per(3 * rt * (m // 64), c // 64)

    def gate_product(w_):
        acc = torch.zeros((n, m))
        for k0 in range(0, c, 64 * gate_per):
            part = torch.zeros((n, m))
            for k1 in range(k0, min(c, k0 + 64 * gate_per), 64):
                part = ktile(part, h[:, k1:k1 + 64], w_[k1:k1 + 64])
            acc = acc + part
        return acc

    gs = []
    for wa_, ba_, wb_, bb_, _, _ in towers:
        a, b = gate_product(wa_), gate_product(wb_)
        if q:
            a, b = _fma(a, ba_[0], ba_[1]), _fma(b, bb_[0], bb_[1])
        else:
            a, b = a + ba_, b + bb_
        gs.append(a * torch.relu(b))
    # the output product's k-tiles: (tower, k0) for the towers, then taps
    tiles = [(t, k0) for t in range(3) for k0 in range(0, m, 64)]
    tiles += [(None, tap) for tap in range(9)] if conv is not None else []
    out_per = _split_per(rt * (c // 64), len(tiles))
    if conv is not None:
        (b_, hh, ww), (ck, _) = hw, conv
        hp = F.pad(h.reshape(b_, hh, ww, c), (0, 0, 1, 1, 1, 1))
    out = torch.zeros((n, c))
    for s0 in range(0, len(tiles), out_per):
        split = tiles[s0:s0 + out_per]
        acc, total = torch.zeros((n, c)), torch.zeros((n, c))
        for i, (t, k0) in enumerate(split):
            if t is None:
                ky, kx = divmod(k0, 3)
                shifted = hp[:, ky:ky + hh, kx:kx + ww].reshape(-1, c)
                for g0 in range(0, c, 32):
                    cols = slice(g0, g0 + 32)
                    total[:, cols] = _ktile(total[:, cols], shifted[:, cols],
                                            ck[ky, kx, :, cols])
                continue
            acc = ktile(acc, gs[t][:, k0:k0 + 64], towers[t][4][k0:k0 + 64])
            last = i + 1 == len(split) or split[i + 1][0] != t
            if last:
                total = total + (acc * towers[t][5][0] if q else acc)
                acc = torch.zeros((n, c))
        out = out + total
    bias_of = lambda t: t[5][1] if q else t[5]
    out_bias = bias_of(towers[0]) + bias_of(towers[1]) + bias_of(towers[2])
    if conv is not None:
        out_bias = out_bias + conv[1]
    return out + out_bias, h


# (route, shape, whether the Pallas kernel runs too): the int8 routes and
# fp32 ffn_block; block_core (B, map side, C), ffn_block (rows, C). The
# deep cases at C = M = 1024: block_core's output product 3M + 288 = 3360
# deep, split into 12 blocks of 5 k-tiles, some across two towers (the
# per-tower scaling inside a split) or a tower and the conv taps; ffn_block's
# 3M deep, 12 blocks of 4 k-tiles
FWD_CASES = [
    ("block_core_int8", (1, 8, 128), True),
    ("block_core_int8", (1, 4, 1024), False),
    ("ffn_block_int8", (40, 128), True),
    ("ffn_block_int8", (16, 1024), False),
    ("ffn_block", (40, 128), True),
    ("ffn_block", (16, 1024), False),
]


@pytest.mark.parametrize("route,shape,pallas", FWD_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s, _ in FWD_CASES])
def test_tf32_ffn_forward_routes_match_jax(route, shape, pallas):
    """The emulated fp32 ffn_block route and the int8 routes of block_core
    and ffn_block against the JAX package at 1e-4: its XLA function (on
    fake_quantize'd weights for int8) and, where `pallas`, its Pallas
    kernel in interpret mode (quantized=True for int8, which quantizes as
    the emulation does)."""
    t = lambda a: torch.from_numpy(np.array(a))
    q = route.endswith("_int8")
    ids = (1, 3)
    ids_j = jnp.asarray(ids, jnp.int32)
    if route.startswith("block_core"):
        x, mul, bias, w, ck, cb = _block_case(*shape, seed=sum(shape) + 7)
        b_, hw, c = shape
        rows = lambda a: a.reshape(-1, c)
        film = lambda a: np.broadcast_to(a, x.shape)
    else:
        n, c = shape
        rng = np.random.default_rng(n + c)
        r = lambda *s, scale=0.05: (rng.normal(size=s) * scale).astype(np.float32)
        x, mul, bias = r(n, c, scale=1.0), r(n, c, scale=0.2) + 1.0, r(n, c, scale=0.2)
        w = (r(c, c), r(c), r(c, c), r(c), r(c, c), r(c),
             r(4, c, c), r(4, c), r(4, c, c), r(4, c), r(4, c, c), r(4, c))
        rows = film = lambda a: a
    jw = [jnp.asarray(a) for a in w]
    if q:
        # the int8 values and [scale; bias] rows, as the Pallas kernels make them
        qw = [jffn.quantize_cols(m_, b_) for m_, b_ in zip(jw[0::2], jw[1::2])]
        mats = [t(m_).float() for m_, _ in qw]
        sbs = [t(sb) for _, sb in qw]
        # fake_quantize: the XLA reference's weights
        jref = [v for m_, b_ in zip(jw[0::2], jw[1::2]) for v in jffn.fake_quantize(m_, b_)]
    else:
        mats, sbs = [t(a) for a in w[0::2]], [t(a) for a in w[1::2]]
        jref = jw
    towers = [tuple(v for k in range(3) for v in (mats[k], sbs[k]))] + [
        tuple(v for k in range(3) for v in (mats[3 + k][e], sbs[3 + k][e])) for e in ids]
    if route.startswith("block_core"):
        conv = (t(ck), t(cb))
        out, h = _ffn_fwd_tc(t(rows(x)), t(rows(film(mul))), t(rows(film(bias))), towers, q,
                             conv=conv, hw=(b_, hw, hw))
        out = (out + t(rows(x))).reshape(x.shape)
        h = h.reshape(x.shape)
        args = [jnp.asarray(a) for a in (x, mul, bias)]
        refs = [jbc.block_core_xla(*args, *jref, jnp.asarray(ck), jnp.asarray(cb), *ids)]
        if pallas:
            refs.append(jbc.block_core_pallas(*args, *jw, jnp.asarray(ck), jnp.asarray(cb),
                                              ids_j, quantized=q, interpret=True))
    else:
        out, h = _ffn_fwd_tc(t(x), t(mul), t(bias), towers, q)
        args = [jnp.asarray(a) for a in (x, mul, bias)]
        refs = [jffn.ffn_block_xla(*args, *jref, *ids)]
        if pallas:
            refs.append(jffn.ffn_block_pallas(*args, *jw, ids_j, quantized=q, interpret=True))
    for ref_out, ref_h in refs:
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)


@pytest.mark.parametrize("kernel,towers_on,conv_passes", [
    ("block_core", ("tf32", 3), 3), ("ffn_block", ("tf32", 3), 0),
    ("block_core_int8", (torch.bfloat16, 3), 3), ("ffn_block_int8", (torch.bfloat16, 3), 0)])
def test_tf32_bound_counts_each_routes_passes(kernel, towers_on, conv_passes):
    """workloads.work for an fp32 call of the forward FFN routes: every
    product at the least-cost fp32-accurate rate on the tensor cores,
    three TF32 passes with fp32 weights (and on block_core's conv), three
    bf16 passes on the int8 towers (q exact in bf16; three bf16 passes at
    989 TFLOP/s beat two TF32 ones at 495); the bound adds the tensor
    cores' TF32 and bf16 times; the bytes those of fp32 activations and
    of the weights' type."""
    call = workloads.Call(kernel, 1, 64, 256, 36)
    nbytes, ops = workloads.work(call, torch.float32)
    rows, c = 64 * 64, 256
    towers, conv = 18 * rows * c * c, 2 * rows * c * 9 * 32
    unit, passes = towers_on
    want = {unit: passes * towers}
    if conv_passes:
        want["tf32"] = want.get("tf32", 0) + conv_passes * conv
    assert ops == want
    bf16_bytes, bf16_ops = workloads.work(call, torch.bfloat16)
    assert bf16_ops == {torch.bfloat16: towers + (conv if conv_passes else 0)}
    assert nbytes > bf16_bytes
    assert 2 / workloads.PEAK_FLOPS["tf32"] > 3 / workloads.PEAK_FLOPS[torch.bfloat16]
    bound, by = workloads.bound_ms(call, torch.float32)
    assert by == "operations" and bound == pytest.approx(
        sum(n / workloads.PEAK_FLOPS[u] for u, n in want.items()) * 1e3)
