"""The port's sample-quality metric (utils/quality.py) and profiling
harness (utils/profiling.py) on the CPU: every function of the KID module
against the JAX package's on numpy inputs (features at the fp32
tolerance, the KID value at rtol 1e-4 and atol 1e-5), the committed
random-conv weights bitwise the JAX package's draws, kid_mean_std with
JAX's subset indices injected, kid_from_images through a port Encoder
converted from flax parameters; then fence, time_fn, chained_time and
trace on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.models.vae import Encoder as JEncoder
from ldm_image_generator_tpu.utils import quality as jq
from ldm_image_generator_tpu_torch.config import VAEConfig
from ldm_image_generator_tpu_torch.convert import encoder_from_flax
from ldm_image_generator_tpu_torch.utils import profiling
from ldm_image_generator_tpu_torch.utils import quality as tq

torch.set_num_threads(1)

# fp32 on the CPU (tests/test_models_parity.py)
TOL = dict(rtol=5e-4, atol=5e-5)
KID_TOL = dict(rtol=1e-4, atol=1e-5)
np_tree = lambda p: jax.tree.map(np.asarray, p)


def _feats(n, d, seed, shift=0.0):
    return (np.random.default_rng(seed).normal(size=(n, d)) + shift).astype(np.float32)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


def test_committed_conv_weights_are_the_jax_draws():
    """random_conv_weights.npz holds what the JAX package's
    random_conv_features draws for RGB images: jax.random.normal under
    fold_in(PRNGKey(0xC0FFEE), i), He-scaled by sqrt(2 / (9 cin)),
    bitwise."""
    key = jax.random.PRNGKey(0xC0FFEE)
    cin = 3
    with np.load(tq.WEIGHTS) as f:
        assert sorted(f.files) == ["w0", "w1", "w2"]
        for i, cout in enumerate((16, 32, 64)):
            want = np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                (3, 3, cin, cout), jnp.float32)
                              * jnp.sqrt(2.0 / (3 * 3 * cin)))
            assert f[f"w{i}"].dtype == np.float32
            np.testing.assert_array_equal(f[f"w{i}"], want)
            cin = cout
    assert sum(w.numel() for w in tq.conv_weights("cpu")) == 23472


@pytest.mark.parametrize("shape", [(2, 32, 30, 3), (1, 33, 17, 3)])
def test_random_conv_features_match_jax(shape):
    """Even and odd sides (XLA's SAME padding at stride 2 pads after on
    an even side, on both sides on an odd one), patch 4 and 2."""
    x = _images(shape, 1)
    for patch in (4, 2):
        want = np.asarray(jax.jit(jq.random_conv_features, static_argnums=(1, 2))(
            jnp.asarray(x), 0xC0FFEE, patch))
        got = tq.random_conv_features(torch.from_numpy(x), patch)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="RGB"):
        tq.random_conv_features(torch.zeros(1, 8, 8, 4))


def test_patch_features_and_poly_kernel_match_jax():
    lat = _images((2, 9, 7, 8), 2)
    for patch in (4, 3, 16):
        np.testing.assert_array_equal(
            tq.patch_features(torch.from_numpy(lat), patch).numpy(),
            np.asarray(jq.patch_features(jnp.asarray(lat), patch)))
    a, b = _feats(6, 16, 3), _feats(5, 16, 4)
    np.testing.assert_allclose(
        tq._poly_kernel(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jq._poly_kernel(jnp.asarray(a), jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_kid_matches_jax(shift):
    """Same and shifted distributions, sets of unequal size."""
    x, y = _feats(40, 32, 5), _feats(30, 32, 6, shift)
    want = float(jq.kid(jnp.asarray(x), jnp.asarray(y)))
    got = tq.kid(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, **KID_TOL)
    if shift:
        assert got.item() > 3 * abs(float(jq.kid(jnp.asarray(x), jnp.asarray(_feats(30, 32, 7)))))


def test_kid_mean_std_with_jax_subsets():
    """kid_subsets on the subset indices JAX's kid_mean_std draws
    (jax.random.choice without replacement per split key) gives its mean
    and std; the port's kid_mean_std draws distinct indices from a
    generator and reduces them the same way."""
    x, y = _feats(24, 16, 8), _feats(20, 16, 9, 0.3)
    key = jax.random.PRNGKey(11)
    want = jq.kid_mean_std(jnp.asarray(x), jnp.asarray(y), key, num_subsets=5)
    s = 10
    rows = []
    for k in jax.random.split(key, 5):
        kr, kf = jax.random.split(k)
        rows.append((np.asarray(jax.random.choice(kr, 24, (s,), replace=False)),
                     np.asarray(jax.random.choice(kf, 20, (s,), replace=False))))
    idx = lambda j: torch.from_numpy(np.stack([r[j] for r in rows]).astype(np.int64))
    got = tq.kid_subsets(torch.from_numpy(x), torch.from_numpy(y), idx(0), idx(1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), **KID_TOL)
    gen = torch.Generator().manual_seed(0)
    mean, std = tq.kid_mean_std(torch.from_numpy(x), torch.from_numpy(y), gen,
                                num_subsets=5, subset_size=6)
    gen = torch.Generator().manual_seed(0)
    draws = [(torch.randperm(24, generator=gen)[:6], torch.randperm(20, generator=gen)[:6])
             for _ in range(5)]
    again = tq.kid_subsets(torch.from_numpy(x), torch.from_numpy(y),
                           torch.stack([d[0] for d in draws]),
                           torch.stack([d[1] for d in draws]))
    assert mean.item() == again[0].item() and std.item() == again[1].item() > 0


def test_kid_from_images_matches_jax():
    """Patched KID of two 16px image sets through a tiny VAE Encoder:
    the JAX Encoder's parameters converted into a port Encoder."""
    jcfg = JVAEConfig().tiny()
    real, fake = _images((6, 16, 16, 3), 12), _images((5, 16, 16, 3), 13) * 0.5
    enc = JEncoder(jcfg)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(real[:1]))
    want = float(jq.kid_from_images(enc, params, jnp.asarray(real), jnp.asarray(fake)))
    port = encoder_from_flax(np_tree(params), VAEConfig().tiny(), device="cpu")
    got = tq.kid_from_images(port, torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(got.item(), want, **KID_TOL)
    # the random-conv path on the same images
    want = float(jq.kid(jq.random_conv_features(jnp.asarray(real)),
                        jq.random_conv_features(jnp.asarray(fake))))
    got = tq.kid(tq.random_conv_features(torch.from_numpy(real)),
                 tq.random_conv_features(torch.from_numpy(fake)))
    np.testing.assert_allclose(got.item(), want, **KID_TOL)


def test_profiling_on_the_cpu(tmp_path):
    """fence returns its argument untouched, time_fn and chained_time
    give positive seconds (chained_time applies the step chain_len times
    per chain), and trace writes a Chrome trace holding the named scope."""
    x = torch.ones(4, 4)
    out = {"a": [x, (x, 3)], "b": None}
    assert profiling.fence(out) is out
    secs, res = profiling.time_fn(torch.matmul, x, x, iters=3, warmup=1)
    assert secs > 0 and torch.equal(res, x @ x)
    calls = []

    def step(v, k):
        calls.append(1)
        return v * k

    per = profiling.chained_time(step, x, torch.tensor(1.0), chain_len=5, iters=2, warmup=1)
    assert per > 0 and len(calls) == 5 * 3
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.named_scope("kid_scope"):
            tq.kid(torch.from_numpy(_feats(8, 4, 1)), torch.from_numpy(_feats(8, 4, 2)))
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "kid_scope" for e in events)
    assert any(ev.key == "kid_scope" for ev in prof.key_averages())
