"""The port at a 64x64 latent (the size 512px sampling gives the default
VAE; here the tiny VAE's 128px image) against the JAX package on the CPU,
fp32, tiny widths: window attention over a 64x64 map (pad to 66, 121
windows, shifted and not) against JAX's Pallas kernel in interpret mode,
LDMPipeline.sample, one train step with v-prediction, zero terminal SNR
and Min-SNR gamma 5, a server of two sizes, and the sampling CLI at its
default size (512px)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.diffusion import ddpm as jddpm
from ldm_image_generator_tpu.kernels import window_attention as jattn
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.ops import window as jwin
from ldm_image_generator_tpu import pipelines as jpipelines
from ldm_image_generator_tpu.pipelines import LDMPipeline as JPipeline
from ldm_image_generator_tpu.train import steps as jsteps
from ldm_image_generator_tpu_torch.cli import sample_ldm, serve
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import (
    decoder_from_flax,
    flatten_tree,
    unet_from_flax,
)
from ldm_image_generator_tpu_torch.diffusion import ddpm as tddpm
from ldm_image_generator_tpu_torch.models.layers import ParamInit, WindowAttention
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
from ldm_image_generator_tpu_torch.serving import SamplerServer
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

LATENT = 64
IMAGE = 128   # the tiny VAE downscales by 2
STEPS = 3
# fp32 (tests/test_models_parity.py); the Pallas interpret run sums the
# products in another order (tests/test_torch_port_kernels.py)
TOL = dict(rtol=5e-4, atol=5e-5)
TOL_PALLAS = dict(rtol=5e-4, atol=5e-4)
np_tree = lambda p: jax.tree.map(np.asarray, p)
# the updated parameters' exemption rule of tests/test_torch_port_train.py
GRAD_ZERO, GRAD_ATOL, GRAD_RTOL, EXEMPT_SHARE = 1e-5, 1e-6, 1e-2, 0.1


def _jax_draws(key, b, shape, num_timesteps=1000):
    """The t and eps JAX's ddpm_loss draws from `key`."""
    key_t, key_eps, _ = jax.random.split(key, 3)
    t = jax.random.randint(key_t, (b,), 1, num_timesteps)
    eps = jax.random.normal(key_eps, shape)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("shift", [0, 3], ids=["unshifted", "shifted"])
def test_window_attention_on_a_64_map_matches_jax_pallas(shift):
    """The port's WindowAttention (pad 64 -> 66, 121 windows of 36 tokens,
    the pad mask rolled with a shifted map; window_mha's plain version)
    against JAX's window ops around window_mha_pallas in interpret mode,
    on the same weights."""
    c, heads, ws = 64, 2, 6
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, LATENT, LATENT, c)).astype(np.float32)
    layer = WindowAttention(c, heads, ParamInit("cpu", torch.Generator().manual_seed(0)),
                            window_size=ws, shift=shift)
    m = layer.mha
    with torch.no_grad():
        for b in (m.bq, m.bk, m.bv, m.bo):
            b.copy_(torch.from_numpy(rng.normal(size=c).astype(np.float32) * 0.05))
    got = layer(torch.from_numpy(x)).detach().numpy()
    w = [jnp.asarray(t.detach().numpy())
         for t in (m.wq, m.bq, m.wk, m.bk, m.wv, m.bv, m.wo, m.bo)]
    xp, _, _ = jwin.pad_to_window_multiple(jnp.asarray(x), ws)
    hp, wp = xp.shape[1], xp.shape[2]
    mask2d = jwin.pad_mask(LATENT, LATENT, hp, wp)
    if shift:
        xp = jwin.shift_2d(xp, shift)
        mask2d = jnp.roll(mask2d, (shift, shift), axis=(0, 1))
    wins = jwin.partition_windows(xp, ws)
    mask = jwin.partition_windows(mask2d[None, :, :, None], ws)[:, :, 0]
    assert wins.shape == (121, 36, c) and bool(mask.any())
    out = jattn.window_mha_pallas(wins, mask, *w, num_heads=heads, interpret=True)
    out = jwin.merge_windows(out, 1, hp, wp, ws)
    if shift:
        out = jwin.shift_2d(out, -shift)
    np.testing.assert_allclose(got, np.asarray(out[:, :LATENT, :LATENT, :]), **TOL_PALLAS)


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, its UNet and Decoder params, port pipeline on the
    same weights), tiny config with routing pinned to experts (0, 1)."""
    ucfg = JUNetConfig(fixed_expert_indices=(0, 1)).tiny()
    jp = JPipeline(ucfg, JVAEConfig().tiny(), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1, LATENT, LATENT, ucfg.input_channels))
    up = jax.jit(jp.unet.init)({"params": key, "moe": key}, z0, jnp.zeros((1,), jnp.int32))
    dp = jax.jit(jp.decoder.init)(key, z0)
    tp = LDMPipeline(
        unet_from_flax(np_tree(up), UNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                       device="cpu"),
        decoder_from_flax(np_tree(dp), VAEConfig().tiny(), device="cpu"),
        dtype=torch.float32)
    return jp, up, dp, tp


def test_sample_at_latent_64_matches_jax(pipes):
    """LDMPipeline.sample (DDIM, 3 steps) against JAX's on the same x_T:
    the final latent and its decode each within the fp32 rtol of their
    scale (random weights carry them to thousands, so an element near 0
    holds the rounding of the whole; 2 of the 49,152 uint8 values then
    sit 2 levels apart). JAX's latent is its ddim_sample over the same
    UNet, whose decode gives jp.sample's uint8 image exactly."""
    jp, up, dp, tp = pipes
    noise = np.random.default_rng(1).normal(size=(1, LATENT, LATENT, 8)).astype(np.float32)
    ref = np.asarray(jp.sample(up, dp, jax.random.PRNGKey(1), batch=1, image_size=IMAGE,
                               num_steps=STEPS, init_noise=jnp.asarray(noise)))
    zj = jddpm.ddim_sample(lambda x, t, k: jp.unet.apply(up, x, t), jp.schedule,
                           jax.random.PRNGKey(1), noise.shape, num_steps=STEPS,
                           init_noise=jnp.asarray(noise))
    dj = jp.decoder.apply(dp, zj)
    assert np.array_equal(np.asarray(jpipelines.to_uint8(dj)), ref)
    img, z = tp.sample(batch=1, image_size=IMAGE, num_steps=STEPS,
                       init_noise=torch.from_numpy(noise), return_latent=True)
    assert img.dtype == torch.uint8 and img.shape == ref.shape == (1, IMAGE, IMAGE, 3)
    assert tuple(z.shape) == (1, LATENT, LATENT, 8) and torch.isfinite(z).all()
    with torch.no_grad():
        decoded = tp.decoder(z).numpy()
    for got, want in ((z.numpy(), np.asarray(zj)), (decoded, np.asarray(dj))):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= TOL["rtol"] * scale, (np.abs(got - want).max(), scale)


def test_v_zero_snr_min_snr_train_step_at_latent_64_matches_jax():
    """One AdamW step of the tiny UNet (routing pinned, no stochastic
    depth) on 64x64 latents with v-prediction, the zero-terminal-SNR
    schedule and Min-SNR gamma 5, t and noise drawn by JAX and injected:
    the loss against the jitted JAX step's, every gradient against an
    eager jax.grad of the same loss, and the updated parameters against
    the JAX step's, an element exempt where JAX's gradient (read back from
    its Adam first moment) lies within rounding of 0 or of the port's
    (tests/test_torch_port_train.py's rule and share)."""
    jcfg = dataclasses.replace(JUNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                               stochastic_depth=0.0)
    tcfg = dataclasses.replace(UNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                               stochastic_depth=0.0)
    dcfg = dict(prediction="v", zero_terminal_snr=True)
    junet = JUNet(jcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(2).normal(size=(2, LATENT, LATENT, 8)).astype(np.float32)
    params = jax.jit(junet.init)({"params": key, "moe": key, "sd": key},
                                 jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32))
    jsched = jddpm.make_schedule(JDDPMConfig(**dcfg))
    jtx = jsteps.make_optimizer("adamw", 1e-3)
    jstate = jsteps.LDMTrainState(params=params, opt_state=jtx.init(params),
                                  step=jnp.zeros((), jnp.int32), ema_params=None)
    jstep = jax.jit(jsteps.make_ldm_train_step(junet, jsched, jtx, prediction="v",
                                               min_snr_gamma=5.0))
    tunet = unet_from_flax(np_tree(params), tcfg, device="cpu")
    ttx = tsteps.make_optimizer("adamw", 1e-3)
    tstate = tsteps.LDMTrainState(params=tunet, opt_state=ttx.init(list(tunet.parameters())))
    tstep = tsteps.make_ldm_train_step(tunet, tddpm.make_schedule(DDPMConfig(**dcfg)), ttx,
                                       prediction="v", min_snr_gamma=5.0)

    def jloss(p, k):
        def denoise(xt, t, kk):
            return junet.apply(p, xt, t, deterministic=False,
                               rngs={"moe": kk, "sd": kk}).astype(jnp.float32)
        return jddpm.ddpm_loss(denoise, jsched, jnp.asarray(x), k, prediction="v",
                               min_snr_gamma=5.0)

    k = jax.random.fold_in(key, 0)
    ref_loss, ref_grads = jax.value_and_grad(jloss)(params, k)
    jstate, jm = jstep(jstate, jnp.asarray(x), k)
    t, eps = _jax_draws(k, 2, x.shape)
    tstate, tm = tstep(tstate, torch.from_numpy(x), t=t, eps=eps)
    np.testing.assert_allclose(float(jm["loss"]), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
    flat = lambda tree: flatten_tree(np_tree(tree)["params"])
    got = {n: p.grad.numpy() for n, p in tunet.named_parameters()}
    ref = flat(ref_grads)
    assert set(got) == set(ref)
    for n in ref:
        np.testing.assert_allclose(got[n], ref[n], err_msg=n, **TOL)
    exempt = {}
    for n, m in flat(jstate.opt_state[0].mu).items():  # m = 0.1 g (first step)
        g_jax = m.astype(np.float64) / 0.1
        zero = (np.abs(g_jax) <= GRAD_ZERO) & ~((g_jax == 0) & (got[n] == 0))
        exempt[n] = zero | (np.abs(got[n] - g_jax) > GRAD_ATOL + GRAD_RTOL * np.abs(g_jax))
    assert sum(int(e.sum()) for e in exempt.values()) <= EXEMPT_SHARE * sum(
        e.size for e in exempt.values())
    ours = dict(tunet.named_parameters())
    for n, v in flat(jstate.params).items():
        keep = ~exempt[n]
        np.testing.assert_allclose(ours[n].detach().numpy()[keep], v[keep], err_msg=n, **TOL)


def test_two_size_server_serves_the_second_size_as_the_direct_sample(pipes):
    """make_variants over sizes 16 and 128: requests of both sizes queued
    together; each dispatch holds one size (its own bucket), and the 128px
    images equal the direct LDMPipeline.sample from draw_noise rows at
    that bucket, bit for bit."""
    tp = pipes[3]
    variants, _ = serve.make_variants(tp, [16, IMAGE], num_steps=STEPS)
    seen = []
    sample = tp.sample

    def recording(*a, **k):
        seen.append((k["image_size"], k["batch"]))
        return sample(*a, **k)

    srv = SamplerServer(variants, batch_buckets=(1, 2, 4), max_wait_ms=5, device="cpu")
    reqs = [(16, 3), (IMAGE, 20), (16, 4), (IMAGE, 21), (IMAGE, 22)]
    futs = [srv.submit(seed, variant=size) for size, seed in reqs]
    tp.sample = recording
    try:
        with srv:
            imgs = [f.result(timeout=120) for f in futs]
    finally:
        del tp.sample
    assert sorted(seen) == [(16, 2), (IMAGE, 4)]
    for (size, _), img in zip(reqs, imgs):
        assert img.shape == (size, size, 3) and img.dtype == np.uint8
    rows = torch.stack([serve.draw_noise(s, (LATENT, LATENT, 8)) for s in (20, 21, 22, 0)])
    ref = tp.sample(torch.Generator().manual_seed(0), batch=4, image_size=IMAGE,
                    num_steps=STEPS, init_noise=rows).numpy()
    for j, i in enumerate((1, 3, 4)):
        assert np.array_equal(imgs[i], ref[j]), j


def test_sample_cli_defaults_to_512px(tmp_path, monkeypatch, capsys):
    """cli/sample_ldm with no -s (and no -fp16: fp32) writes a 512x512
    PNG; --config tiny, one step, on the CPU."""
    monkeypatch.chdir(tmp_path)
    sample_ldm.main(["--config", "tiny", "-t", "1", "-d", "cpu", "-o", "out"])
    import PIL.Image

    with PIL.Image.open(tmp_path / "out" / "0.png") as img:
        assert img.size == (512, 512) and img.mode == "RGB"
    assert "saved 1 images" in capsys.readouterr().out
