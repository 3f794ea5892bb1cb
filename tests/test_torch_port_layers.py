"""The port's layers against the JAX package's flax modules: each is built
in JAX at tiny width, its params carried across with convert.py, and both
run on the same numpy inputs (CPU, fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.models import layers as jl
from ldm_image_generator_tpu.models import vae as jvae
from ldm_image_generator_tpu_torch.config import VAEConfig
from ldm_image_generator_tpu_torch.convert import (
    decoder_from_flax,
    load_flax_params,
)
from ldm_image_generator_tpu_torch.models import layers as tl

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-5)
INIT = tl.ParamInit("cpu")


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _perturb(params, seed):
    """Random values in place of flax's zero biases, so biases count."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                              * (0.05 if a.ndim <= 2 else 0.1)), params)


@pytest.mark.parametrize("pair_id", range(6))
def test_random_moe_pair_ids_match(pair_id):
    c, b, hw = 32, 2, 4
    rng = np.random.default_rng(pair_id)
    x = rng.normal(size=(b, hw, hw, c)).astype(np.float32)
    mul = (rng.normal(size=(1, hw, hw, c)) * 0.2 + 1).astype(np.float32)
    bias = (rng.normal(size=(1, hw, hw, c)) * 0.2).astype(np.float32)
    jm = jl.RandomMoE(c)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    ref_out, ref_h = jm.apply(params, jnp.asarray(x), film_mul=jnp.asarray(mul),
                              film_bias=jnp.asarray(bias),
                              pair_id=jnp.int32(pair_id))
    tm = load_flax_params(tl.RandomMoE(c, INIT), _np_tree(params))
    with torch.no_grad():
        out, h = tm(torch.from_numpy(x), torch.from_numpy(mul),
                    torch.from_numpy(bias), pair_id=pair_id)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)


@pytest.mark.parametrize("attention,shift,batch,hw", [
    (True, 3, 1, 8),    # shifted windows with a padded mask, block_core path
    (True, 0, 3, 8),    # unshifted windows, ffn_block + grouped conv path
    (False, 0, 2, 5),   # no attention, block_core path, odd map
    (True, 3, 2, 4),    # map within one window: full attention, no mask
])
def test_swin_block_matches(attention, shift, batch, hw):
    c = 64
    rng = np.random.default_rng(hw + batch)
    x = rng.normal(size=(batch, hw, hw, c)).astype(np.float32)
    t = np.asarray([417], np.int32)
    jb = jl.SwinBlock(c, shift=shift, attention=attention,
                      fixed_expert_indices=(1, 2))
    params = _perturb(
        jb.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t)), 3)
    ref = jb.apply(params, jnp.asarray(x), jnp.asarray(t))
    tb = load_flax_params(
        tl.SwinBlock(c, INIT, shift=shift, attention=attention,
                     fixed_expert_indices=(1, 2)), _np_tree(params))
    with torch.no_grad():
        out = tb(torch.from_numpy(x), torch.from_numpy(t))
        # the FiLM-schedule form of the same block: film collected for t
        film = tb.encodings.film(hw, hw, torch.from_numpy(t))
        out_film = tb(torch.from_numpy(x), torch.from_numpy(t), film=film)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(out_film.numpy(), out.numpy())


def test_cross_attention_matches():
    c, ckv = 64, 48
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 5, c)).astype(np.float32)
    cond = rng.normal(size=(2, 4, ckv)).astype(np.float32)
    jm = jl.CrossAttention(c, 2)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(cond)), 9)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(cond))
    tm = load_flax_params(tl.CrossAttention(c, 2, INIT, kv_channels=ckv),
                          _np_tree(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_decoder_matches_with_odd_input():
    """Odd 5x3 latent: bilinear_up_2x's borders against jax.image.resize
    and the flax ConvTranspose kernel orientation (no transpose flip)."""
    cfg = JVAEConfig().tiny()
    z = np.random.default_rng(6).normal(size=(2, 5, 3, cfg.latent_channels))
    z = z.astype(np.float32)
    jd = jvae.Decoder(cfg)
    params = _perturb(jd.init(jax.random.PRNGKey(0), jnp.asarray(z)), 11)
    ref = jd.apply(params, jnp.asarray(z))
    td = decoder_from_flax(_np_tree(params), VAEConfig().tiny(), device="cpu")
    with torch.no_grad():
        out = td(torch.from_numpy(z))
    assert out.shape == ref.shape == (2, 10, 6, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_convert_raises_on_missing_or_extra_names():
    c = 32
    params = _np_tree(jl.GroupedConv2d(c).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, c))))
    load_flax_params(tl.GroupedConv2d(c, INIT), params)
    inner = dict(params["params"])
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(tl.GroupedConv2d(c, INIT),
                         {"kernel": inner["kernel"]})
    with pytest.raises(KeyError, match="extra"):
        load_flax_params(tl.GroupedConv2d(c, INIT),
                         dict(inner, stray=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(tl.GroupedConv2d(c, INIT),
                         dict(inner, bias=np.zeros(c + 1, np.float32)))
