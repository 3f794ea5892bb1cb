"""The port's backward kernels' plain versions and its autograd wrappers
against the JAX package (CPU, fp32): ffn_block_bwd against the Pallas
backward in interpret mode and against jax.vjp of ffn_block_xla,
window_mha_bwd likewise against window_mha_bwd_pallas and window_mha_xla,
and the block_core gradients against jax.vjp of block_core_xla. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_port_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.kernels import block_core as jbc
from ldm_image_generator_tpu.kernels import ffn_block as jffn
from ldm_image_generator_tpu.kernels import window_attention as jattn
from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.kernels import window_attention as tattn

torch.set_num_threads(1)

# fp32 on the CPU, the tolerance of tests/test_torch_port_kernels.py; the
# Pallas interpret runs and the XLA VJPs sum in other orders than the
# port, so those comparisons take that file's Pallas tolerance
TOL = dict(rtol=5e-4, atol=5e-5)
TOL_PALLAS = dict(rtol=5e-4, atol=5e-4)
FFN_NAMES = ("dx", "dmul", "dbias", "dgwa", "dgba", "dgwb", "dgbb", "dgwc",
             "dgbc", "dwa", "dba", "dwb", "dbb", "dwc", "dbc")


def _rng_arrays(seed, shapes, scale=0.05):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _ffn_inputs(rows, c=128, m=128, e=4, film_rows=None, seed=0):
    fr = film_rows or rows
    x, = _rng_arrays(seed, [(rows, c)], scale=1.0)
    mul, bias = _rng_arrays(seed + 1, [(fr, c), (fr, c)], scale=0.2)
    mul = mul + 1.0
    w = _rng_arrays(seed + 2, [(c, m), (m,), (c, m), (m,), (m, c), (c,),
                               (e, c, m), (e, m), (e, c, m), (e, m),
                               (e, m, c), (e, c)])
    return x, mul, bias, w


def _t(*arrs, grad=False):
    return [torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)
            for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, tol, names):
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **tol)


# bf16, plain version vs the Pallas backward in interpret mode: da, db,
# the gate and dh round to bf16 at the same points from fp32 sums of the
# same products, so a value may differ only where the sums' order moved
# it across a rounding boundary: by one bf16 ulp (at most 2**-7 of its
# magnitude; 2**-14 absolute near 0), which the fp32 weight gradients
# carry as one rounded term of their row sums
TOL_BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -14)


@pytest.mark.parametrize("ids,dtype", [((1, 3), "float32"), ((2, 2), "float32"),
                                       ((1, 3), "bfloat16"), ((2, 2), "bfloat16")],
                         ids=["ids0", "ids1", "ids0-bf16", "ids1-bf16"])
def test_ffn_block_bwd_plain_matches_pallas_interpret(ids, dtype):
    """The towers' backward alone (dh and the 15 fp32 gradients of the
    general ReGLU and the two selected experts), equal ids included; in
    bf16 with h, g and the weights rounded alike on both sides."""
    x, mul, bias, w = _ffn_inputs(rows=40)
    _, h = jffn.ffn_block_xla(*_j(x, mul, bias, *w), *ids)
    g, = _rng_arrays(7, [(40, 128)], scale=1.0)
    gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc = w
    jw = (gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc)
    jdt = getattr(jnp, dtype)
    ref = jffn.ffn_block_bwd_pallas(jnp.asarray(h, jdt), jnp.asarray(g, jdt),
                                    *[a.astype(jdt) for a in _j(*jw)],
                                    jnp.asarray(ids, jnp.int32), interpret=True)
    got = tffn.ffn_block_bwd_plain(
        *[t.to(getattr(torch, dtype)) for t in _t(np.asarray(h), g, *jw)],
        torch.tensor(ids, dtype=torch.int32))
    assert got[0].dtype == getattr(torch, dtype)
    got = [t.float() for t in got]
    ref = [np.asarray(r.astype(jnp.float32)).reshape(np.shape(gt))
           for r, gt in zip(ref, got)]
    _close(got, ref, TOL_PALLAS if dtype == "float32" else TOL_BF16,
           ("dh",) + tuple(f"g{i}" for i in range(15)))


@pytest.mark.parametrize("film_rows", [None, 16])
def test_ffn_block_grads_match_jax_tower_bwd_and_vjp(film_rows):
    """Gradients of both outputs (out and h, nonzero gh) through the
    port's autograd wrapper against the JAX package's whole composition
    _ffn_tower_bwd (Pallas interpret) and against jax.vjp of
    ffn_block_xla; film rows repeating with period 16 sum their
    cotangents over the repeats."""
    rows = 48
    x, mul, bias, w = _ffn_inputs(rows=rows, film_rows=film_rows, seed=3)
    g, gh = _rng_arrays(8, [(rows, 128), (rows, 128)], scale=1.0)
    ids = (0, 2)
    rep = (lambda a: np.tile(a, (rows // film_rows, 1))) if film_rows else (lambda a: a)
    (out, h), vjp = jax.vjp(lambda *d: jffn.ffn_block_xla(*d, *ids),
                            *_j(x, rep(mul), rep(bias), *w))
    ref = list(vjp((jnp.asarray(g), jnp.asarray(gh))))
    if film_rows:
        fold = lambda a: np.asarray(a).reshape(-1, film_rows, 128).sum(0)
        ref[1], ref[2] = fold(ref[1]), fold(ref[2])
    leaves = _t(x, mul, bias, *w, grad=True)
    t_out, t_h = tffn.ffn_block(*leaves, torch.tensor(ids, dtype=torch.int32))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), **TOL)
    torch.autograd.backward((t_out, t_h), _t(g, gh))
    got = [t.grad for t in leaves]
    _close(got, ref, TOL_PALLAS, FFN_NAMES)
    if film_rows is None:
        pallas = jffn._ffn_tower_bwd(
            *_j(x, mul, bias, *w), jnp.asarray(ids, jnp.int32), h,
            jnp.asarray(g), jnp.asarray(gh), interpret=True)
        _close(got, pallas, TOL_PALLAS, FFN_NAMES)


def _attn_inputs(n, l, c, seed=2):
    x, = _rng_arrays(seed, [(n, l, c)], scale=1.0)
    ws = _rng_arrays(seed + 1, [(c, c), (c,)] * 4, scale=0.08)
    g, = _rng_arrays(seed + 2, [(n, l, c)], scale=1.0)
    mask = np.zeros((n, l), bool)
    mask[:, l - l // 6:] = True  # padded keys, as a window over the map's edge
    mask[0, :] = False
    return x, mask, ws, g


ATTN_NAMES = ("dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo")


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("n,l,c,h,fold", [
    (13, 36, 128, 4, 1), (16, 36, 256, 8, 4), (8, 16, 256, 8, 8),
    (6, 36, 256, 8, 5)])
def test_window_mha_bwd_plain_matches_pallas_interpret(n, l, c, h, fold, masked):
    """The shapes of tests/test_kernels.py's Pallas backward test; the
    TPU kernel's head folding (a Mosaic workaround the port does not
    carry) must not change what it computes."""
    x, mask, ws, g = _attn_inputs(n, l, c)
    m = mask if masked else None
    jm = None if m is None else jnp.asarray(m)
    dx, dwqkv, dbqkv, dwo, dbo = jattn.window_mha_bwd_pallas(
        jnp.asarray(x), jm, jnp.asarray(g), *_j(*ws), num_heads=h,
        interpret=True, fold=fold)
    dwqkv, dbqkv = np.asarray(dwqkv), np.asarray(dbqkv)
    ref = [dx] + [a for z in range(3) for a in
                  (dwqkv[:, z * c:(z + 1) * c], dbqkv[z * c:(z + 1) * c])] + [dwo, dbo]
    got = tattn.window_mha_bwd_plain(
        *_t(x), None if m is None else torch.from_numpy(m), *_t(g), *_t(*ws),
        num_heads=h)
    _close(got, ref, TOL_PALLAS, ATTN_NAMES)


@pytest.mark.parametrize("masked", [True, False])
def test_window_mha_grads_match_jax_vjp(masked):
    x, mask, ws, g = _attn_inputs(5, 36, 64, seed=4)
    m = mask if masked else None
    jm = None if m is None else jnp.asarray(m)
    out, vjp = jax.vjp(lambda x_, *w: jattn.window_mha_xla(x_, jm, *w, 2),
                       *_j(x, *ws))
    ref = vjp(jnp.asarray(g))
    leaves = _t(x, *ws, grad=True)
    t_out = tattn.window_mha(leaves[0], None if m is None else torch.from_numpy(m),
                             *leaves[1:], num_heads=2)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), **TOL)
    t_out.backward(_t(g)[0])
    _close([t.grad for t in leaves], ref, TOL_PALLAS, ATTN_NAMES)


def _block_inputs(b, hw, c, film_b, seed):
    x, mul, bias, w = _ffn_inputs(rows=b * hw * hw, c=c, m=c,
                                  film_rows=film_b * hw * hw, seed=seed)
    ck, cb = _rng_arrays(seed + 100, [(3, 3, 32, c), (c,)], scale=0.1)
    shape = lambda a, bb: a.reshape(bb, hw, hw, c)
    return shape(x, b), shape(mul, film_b), shape(bias, film_b), w, ck, cb


@pytest.mark.parametrize("add_residual", [True, False])
@pytest.mark.parametrize("film_b", [1, 2])
def test_block_core_grads_match_jax_vjp(add_residual, film_b):
    """Gradients through the port's block_core (towers' backward, conv
    gradient, residual, norm/FiLM backward) against jax.vjp of
    block_core_xla, with the film at batch 1 (its cotangent summed over
    the batch) and at batch B, the residual folded in or not."""
    b, hw, c = 2, 4, 64
    x, mul, bias, w, ck, cb = _block_inputs(b, hw, c, film_b, seed=5)
    g, gh = _rng_arrays(9, [(b, hw, hw, c)] * 2, scale=1.0)
    ids = (1, 2)
    (out, _), vjp = jax.vjp(
        lambda *d: jbc.block_core_xla(*d, *ids, add_residual=add_residual),
        *_j(x, mul, bias, *w, ck, cb))
    ref = vjp((jnp.asarray(g), jnp.asarray(gh)))
    leaves = _t(x, mul, bias, *w, ck, cb, grad=True)
    t_out, t_h = tbc.block_core(*leaves, torch.tensor(ids, dtype=torch.int32),
                                add_residual=add_residual)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), **TOL)
    torch.autograd.backward((t_out, t_h), _t(g, gh))
    _close([t.grad for t in leaves], ref, TOL_PALLAS,
           FFN_NAMES + ("dconv_kernel", "dconv_bias"))


def test_grads_flow_when_only_one_output_is_used():
    """A cotangent for out alone, or for h alone, reaches every input it
    should (the other output's cotangent arrives as None)."""
    x, mul, bias, w, ck, cb = _block_inputs(1, 4, 64, 1, seed=6)
    ids = torch.tensor((0, 3), dtype=torch.int32)
    for pick in (0, 1):
        leaves = _t(x, mul, bias, *w, ck, cb, grad=True)
        outs = tbc.block_core(*leaves, ids, add_residual=True)
        outs[pick].sum().backward()
        assert leaves[0].grad is not None and torch.isfinite(leaves[0].grad).all()
        assert (leaves[15].grad.abs().sum() > 0) == (pick == 0)  # conv kernel


def test_ffn_block_bwd_plain_takes_given_relu_decisions():
    """b_pos (the ReLU decisions a card check takes from the kernel where
    the two sums fell either side of 0): its own decisions give the plain
    version bitwise; one flipped decision of the general tower moves only
    dh's row, and dwb's column and dbb's entry of that unit, by the flipped
    row's db (dg * a) beyond rounding."""
    from ldm_image_generator_tpu_torch.kernels.workloads import Call, make_inputs

    args = make_inputs(Call("ffn_block_bwd", 2, 4, 32, 1), torch.float32, "cpu",
                       torch.Generator().manual_seed(0))
    h, g, gwa, gba, gwb, gbb, gwc, wa, ba, wb, bb, wc, ids = args
    e = ids.long().tolist()
    pos = torch.stack([h @ w + b > 0 for w, b in
                       ((gwb, gbb), (wb[e[0]], bb[e[0]]), (wb[e[1]], bb[e[1]]))])
    want = tffn.ffn_block_bwd_plain(*args)
    same = tffn.ffn_block_bwd_plain(*args, b_pos=pos)
    assert all(torch.equal(a, b) for a, b in zip(want, same))
    row, unit = 3, 5
    pos[0, row, unit] = ~pos[0, row, unit]
    got = tffn.ffn_block_bwd_plain(*args, b_pos=pos)
    moved = lambda a, b: (a - b).abs() > 1e-5
    dh, dwb, dbb = moved(got[0], want[0]), moved(got[3], want[3]), moved(got[4], want[4])
    assert dh[row].any() and not dh[torch.arange(len(dh)) != row].any()
    assert dwb[:, unit].any() and not dwb[:, torch.arange(dwb.shape[1]) != unit].any()
    assert dbb.nonzero().flatten().tolist() == [unit]
    assert all(torch.equal(a, b) for a, b in zip(got[6:], want[6:]))
