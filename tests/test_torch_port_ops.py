"""The port's ops, config and sampler arithmetic against the JAX package
(CPU, fp32). Inputs come from numpy with a fixed seed and go to both."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu import config as jcfg
from ldm_image_generator_tpu import pipelines as jpipe
from ldm_image_generator_tpu.diffusion import ddpm as jddpm
from ldm_image_generator_tpu.ops import norm as jnorm
from ldm_image_generator_tpu.ops import sinusoidal as jsin
from ldm_image_generator_tpu.ops import window as jwin
from ldm_image_generator_tpu_torch import config as tcfg
from ldm_image_generator_tpu_torch import pipelines as tpipe
from ldm_image_generator_tpu_torch.diffusion import ddpm as tddpm
from ldm_image_generator_tpu_torch.ops import norm as tnorm
from ldm_image_generator_tpu_torch.ops import sinusoidal as tsin
from ldm_image_generator_tpu_torch.ops import window as twin

torch.set_num_threads(1)

# fp32 on the CPU, as tests/test_models_parity.py
TOL = dict(rtol=5e-4, atol=5e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["UNetConfig", "VAEConfig", "DDPMConfig"])
def test_config_fields_and_tiny_presets_match(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if hasattr(j, "tiny"):
        assert dataclasses.asdict(t.tiny()) == dataclasses.asdict(j.tiny())
    if hasattr(j, "downscale"):
        assert t.downscale == j.downscale


def test_channel_norm_matches():
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 48)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(tnorm.channel_norm(_t(x)).numpy(),
                               np.asarray(jnorm.channel_norm(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("h,w,c", [(8, 8, 32), (5, 3, 64), (4, 4, 1024)])
def test_positional_encoding_matches(h, w, c):
    np.testing.assert_allclose(tsin.positional_encoding_2d(h, w, c).numpy(),
                               np.asarray(jsin.positional_encoding_2d(h, w, c)),
                               **TOL)


@pytest.mark.parametrize("c", [32, 1024])
def test_time_encoding_matches(c):
    t = np.asarray([0, 1, 17, 526, 999], np.int32)
    # phases reach ~3000 rad at t=999, so sin/cos carry ~1e-4 of fp32
    # argument rounding: compare at the phase's own precision
    np.testing.assert_allclose(tsin.time_encoding_2d(_t(t), c).numpy(),
                               np.asarray(jsin.time_encoding_2d(jnp.asarray(t), c)),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("h,w,ws,shift", [(8, 8, 6, 3), (13, 7, 6, 0), (12, 12, 6, 3)])
def test_window_helpers_match(h, w, ws, shift):
    x = np.random.default_rng(1).normal(size=(2, h, w, 4)).astype(np.float32)
    xp_t, _, _ = twin.pad_to_window_multiple(_t(x), ws)
    xp_j, _, _ = jwin.pad_to_window_multiple(jnp.asarray(x), ws)
    np.testing.assert_array_equal(xp_t.numpy(), np.asarray(xp_j))
    hp, wp = xp_t.shape[1:3]
    np.testing.assert_array_equal(twin.pad_mask(h, w, hp, wp).numpy(),
                                  np.asarray(jwin.pad_mask(h, w, hp, wp)))
    s_t = twin.shift_2d(xp_t, shift)
    s_j = jwin.shift_2d(xp_j, shift)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    p_t = twin.partition_windows(s_t, ws)
    np.testing.assert_array_equal(p_t.numpy(),
                                  np.asarray(jwin.partition_windows(s_j, ws)))
    np.testing.assert_array_equal(
        twin.merge_windows(p_t, 2, hp, wp, ws).numpy(), s_t.numpy())


@pytest.mark.parametrize("kw", [{}, {"zero_terminal_snr": True, "prediction": "v"}])
def test_schedule_matches(kw):
    t = tddpm.make_schedule(tcfg.DDPMConfig(**kw))
    j = jddpm.make_schedule(jcfg.DDPMConfig(**kw))
    for f in ("beta", "alpha", "alpha_bar", "beta_tilde"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)))


@pytest.mark.parametrize("steps", [None, (0, 50, 300, 999)])
def test_step_pairs_and_film_timesteps_match(steps):
    for a, b in zip(tddpm.ddim_step_pairs(1000, 20, steps),
                    jddpm.ddim_step_pairs(1000, 20, steps)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpipe.film_schedule_ts(1000, 20, steps),
                                  jpipe.film_schedule_ts(1000, 20, steps))


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_pred_to_eps_x0_matches(prediction):
    rng = np.random.default_rng(2)
    pred, x = (rng.normal(size=(2, 4, 4, 8)).astype(np.float32) for _ in range(2))
    ab = np.float32(0.37)
    got = tddpm.pred_to_eps_x0(_t(pred), _t(x), ab, prediction)
    want = jddpm.pred_to_eps_x0(jnp.asarray(pred), jnp.asarray(x), ab, prediction)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_to_uint8_matches():
    img = np.random.default_rng(3).normal(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpipe.to_uint8(_t(img)).numpy(),
                                  np.asarray(jpipe.to_uint8(jnp.asarray(img))))


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcfg.resolve_device("cuda")
    assert tcfg.resolve_device("cpu").type == "cpu"

