"""The port's kernel modules against the JAX package: each plain PyTorch
version against the JAX *_xla composition and the Pallas kernel in
interpret mode (CPU, fp32, C=128), plus the CPU dispatch of each wrapper.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_port_cuda.py."""
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

# fp32 on the CPU (tests/test_models_parity.py); the Pallas interpret
# runs sum the FFN/conv products in another order than XLA, so their
# comparison takes the tolerance of tests/test_block_core_kernel.py
TOL = dict(rtol=5e-4, atol=5e-5)
TOL_PALLAS = dict(rtol=5e-4, atol=5e-4)


def _ffn_inputs(rows, c=128, m=128, e=4, film_rows=None, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=0.05: (rng.normal(size=s) * scale).astype(np.float32)
    fr = film_rows or rows
    x = r(rows, c, scale=1.0)
    mul = r(fr, c, scale=0.2) + 1.0
    bias = r(fr, c, scale=0.2)
    w = (r(c, m), r(m), r(c, m), r(m), r(m, c), r(c),
         r(e, c, m), r(e, m), r(e, c, m), r(e, m), r(e, m, c), r(e, c))
    return x, mul, bias, w


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("ids", [(1, 3), (0, 2)])
def test_ffn_block_plain_matches_xla_and_pallas(ids):
    x, mul, bias, w = _ffn_inputs(rows=32)
    out, h = tffn.ffn_block_plain(*_t(x, mul, bias, *w),
                                  torch.tensor(ids, dtype=torch.int32))
    ref_out, ref_h = jffn.ffn_block_xla(*_j(x, mul, bias, *w), *ids)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    p_out, p_h = jffn.ffn_block_pallas(*_j(x, mul, bias, *w),
                                       jnp.asarray(ids, jnp.int32),
                                       interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(p_h), **TOL_PALLAS)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out), **TOL_PALLAS)


def test_ffn_block_periodic_film_rows_match_broadcast():
    """Film rows [F, C] repeat over N = k * F rows (the batch-1 FiLM
    schedule at batch k) exactly as the materialized broadcast."""
    x, mul, bias, w = _ffn_inputs(rows=48, film_rows=16)
    ids = torch.tensor((2, 3), dtype=torch.int32)
    out, h = tffn.ffn_block(*_t(x, mul, bias, *w), ids)
    rep = lambda a: np.tile(a, (3, 1))
    ref_out, ref_h = jffn.ffn_block_xla(*_j(x, rep(mul), rep(bias), *w), 2, 3)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)


def _block_inputs(b=1, hw=4, c=128, film_b=1, seed=1):
    x, mul, bias, w = _ffn_inputs(rows=b * hw * hw, c=c, m=c,
                                  film_rows=film_b * hw * hw, seed=seed)
    rng = np.random.default_rng(seed + 100)
    ck = (rng.normal(size=(3, 3, 32, c)) * 0.1).astype(np.float32)
    cb = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    shape = lambda a, bb: a.reshape(bb, hw, hw, c)
    return shape(x, b), shape(mul, film_b), shape(bias, film_b), w, ck, cb


@pytest.mark.parametrize("add_residual", [True, False])
def test_block_core_plain_matches_xla_and_pallas(add_residual):
    x, mul, bias, w, ck, cb = _block_inputs()
    out, h = tbc.block_core_plain(*_t(x, mul, bias, *w, ck, cb),
                                  torch.tensor((1, 3), dtype=torch.int32),
                                  add_residual=add_residual)
    ref_out, ref_h = jbc.block_core_xla(*_j(x, mul, bias, *w, ck, cb), 1, 3,
                                        add_residual=add_residual)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    p_out, p_h = jbc.block_core_pallas(*_j(x, mul, bias, *w, ck, cb),
                                       jnp.asarray((1, 3), jnp.int32),
                                       add_residual=add_residual,
                                       interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(p_h), **TOL_PALLAS)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out), **TOL_PALLAS)


def _attn_inputs(n=3, l=36, c=128, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, l, c)).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32)
          for s in [(c, c), (c,)] * 4]
    mask = np.zeros((n, l), bool)
    mask[:, 30:] = True  # padded keys, as a window over the map's edge
    mask[0, :] = False
    return x, mask, ws


@pytest.mark.parametrize("masked", [True, False])
def test_window_mha_plain_matches_xla_and_pallas(masked):
    x, mask, ws = _attn_inputs()
    m = mask if masked else None
    out = tattn.window_mha_plain(*_t(x), None if m is None else _t(m)[0],
                                 *_t(*ws), num_heads=4)
    ref = jattn.window_mha_xla(jnp.asarray(x), None if m is None else jnp.asarray(m),
                               *_j(*ws), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    pal = jattn.window_mha_pallas(jnp.asarray(x),
                                  None if m is None else jnp.asarray(m),
                                  *_j(*ws), num_heads=4, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), **TOL_PALLAS)


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    x, mask, ws = _attn_inputs(n=2)
    before = (tattn.launches, tbc.launches, tffn.launches)
    np.testing.assert_array_equal(
        tattn.window_mha(*_t(x, mask), *_t(*ws), num_heads=4).numpy(),
        tattn.window_mha_plain(*_t(x, mask), *_t(*ws), num_heads=4).numpy())
    bx, bm, bb, w, ck, cb = _block_inputs()
    ids = torch.tensor((0, 1), dtype=torch.int32)
    for a, b in zip(tbc.block_core(*_t(bx, bm, bb, *w, ck, cb), ids),
                    tbc.block_core_plain(*_t(bx, bm, bb, *w, ck, cb), ids)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (tattn.launches, tbc.launches, tffn.launches) == before


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which raises here
    (meta tensors have no data); it never falls back quietly."""
    x, mul, bias, w = _ffn_inputs(rows=16)
    meta = [t.to("meta") for t in _t(x, mul, bias, *w)]
    ids = torch.tensor((0, 1), dtype=torch.int32, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        tffn.ffn_block(*meta, ids)
