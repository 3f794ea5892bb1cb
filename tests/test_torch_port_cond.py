"""The port's class-conditional UNet, classifier-free guidance,
DPM-Solver++(2M) and DeepCache against the JAX package (tiny config, CPU,
fp32, routing pinned to experts (0, 1)); the routing plan the two CFG
branches share, the sampler's argument checks and the FiLM memo."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.diffusion import ddim_sample as jddim
from ldm_image_generator_tpu.diffusion.dpm_solver import dpm_solver_sample as jdpm
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.pipelines import LDMPipeline as JPipeline
from ldm_image_generator_tpu.pipelines import to_uint8 as jto_uint8
from ldm_image_generator_tpu_torch.cli import sample_ldm
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import flax_tree
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import Decoder
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-5)
IMAGE = 16   # tiny VAE downscale 2 -> 8x8 latent: one windowed, one full-map stage
CLASSES = 3
FIXED = dict(fixed_expert_indices=(0, 1))


# The samplers are compared under v-prediction: with random weights,
# eps-prediction's x0 = (x - sqrt(1 - ab) eps) / sqrt(ab) scales the UNet's
# miss by up to 1 / sqrt(ab_999), so the latents grow large and fp32
# sums in another order leave errors above atol 5e-5 on the elements
# that cancel; under v-prediction x0 = sqrt(ab) x - sqrt(1 - ab)
# v and every latent stays O(1). The random UNet's output layer is also
# scaled by OUT_GAIN: at lecun scale its outputs are large and the 5-step
# samplers amplify reordered fp32 sums many times over; a trained model's
# output is of unit scale
DDPM = dict(prediction="v")
OUT_GAIN = 0.25


def make_pipes(num_classes: int):
    """(JAX pipeline, UNet and Decoder params, port pipeline on the same
    weights), tiny config, fp32, routing pinned, v-prediction. The
    weights are the port's seeded ones, handed to JAX through flax_tree
    (whose tree must have the structure of the JAX package's init)."""
    ucfg = UNetConfig(num_classes=num_classes, **FIXED).tiny()
    gen = torch.Generator().manual_seed(3)
    unet = UNet(ucfg, device="cpu", generator=gen)
    decoder = Decoder(VAEConfig().tiny(), device="cpu", generator=gen)
    with torch.no_grad():
        unet.decoder_last.kernel.mul_(OUT_GAIN)
    jp = JPipeline(JUNetConfig(num_classes=num_classes, **FIXED).tiny(), JVAEConfig().tiny(),
                   JDDPMConfig(**DDPM), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1, 8, 8, 8))
    up, dp = (jax.tree.map(jnp.asarray, flax_tree(m)) for m in (unet, decoder))
    for tree, init in ((up, lambda: jp.unet.init({"params": key, "moe": key}, z0,
                                                 jnp.zeros((1,), jnp.int32))),
                       (dp, lambda: jp.decoder.init(key, z0))):
        want = jax.eval_shape(init)
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        assert jax.tree.map(jnp.shape, tree) == jax.tree.map(lambda a: a.shape, want)
    return jp, up, dp, LDMPipeline(unet, decoder, DDPMConfig(**DDPM), dtype=torch.float32)


@pytest.fixture(scope="module")
def cond_pipes():
    return make_pipes(CLASSES)


@pytest.fixture(scope="module")
def uncond_pipes():
    return make_pipes(0)


def noise(batch: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(batch, 8, 8, 8)).astype(np.float32)


def jax_sample(jp, up, dp, x_t, num_steps, sampler="ddim", condition=None,
               guidance_scale=1.0, cfg_rescale=0.0, negative_condition=None,
               cache_interval=1):
    """(final latent, uint8 images) of the JAX package's sampler, as
    LDMPipeline._sample_jit runs it, latent included."""
    as_j = lambda a: None if a is None else jnp.asarray(a)
    gs, phi = guidance_scale, cfg_rescale

    def run(up, dp, x_t, cond, gs_arr, phi_arr, neg):
        denoise, base, _ = jp._denoise_fn(
            up, x_t.shape[1], num_steps, None, True, cond,
            gs if gs_arr is None else gs_arr,
            cfg_rescale=phi if phi_arr is None else phi_arr,
            negative_condition=neg)
        deep_cache = None
        if cache_interval > 1:
            deep0 = jnp.zeros(x_t.shape[:3] + (jp.unet_cfg.channels[0],), jnp.float32)
            deep_cache = (lambda x, t, k: base(x, t, k, cond, with_deep=True),
                          lambda x, t, k, d: base(x, t, k, cond, deep=d),
                          deep0, cache_interval)
        samp = jdpm if sampler == "dpm++2m" else jddim
        z = samp(denoise, jp.schedule, jax.random.PRNGKey(1), x_t.shape,
                 num_steps=num_steps, prediction=jp.prediction, init_noise=x_t,
                 deep_cache=deep_cache)
        return z, jto_uint8(jp.decoder.apply(dp, z))

    arr = lambda v: v if isinstance(v, np.ndarray) else None
    z, img = jax.jit(run)(up, dp, jnp.asarray(x_t), as_j(condition), as_j(arr(gs)),
                          as_j(arr(phi)), as_j(negative_condition))
    return np.asarray(z), np.asarray(img)


def assert_images_close(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("kind", ["ids", "null", "tokens"])
def test_conditional_unet_step_matches_jax(cond_pipes, kind):
    """One conditional UNet call: class ids, the null id (num_classes),
    and prebuilt tokens [B, T, D] (passed through)."""
    _, up, _, tp = cond_pipes
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    t = np.array([412], np.int32)
    cfg = tp.unet.cfg
    cond = {"ids": np.array([0, 2], np.int32),
            "null": np.full((2,), CLASSES, np.int32),
            "tokens": rng.normal(size=(2, cfg.cond_tokens, cfg.cond_channels)
                                 ).astype(np.float32)}[kind]
    junet = JUNet(JUNetConfig(num_classes=CLASSES, **FIXED).tiny())
    ref = jax.jit(junet.apply)(up, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        out = tp.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cfg_sample_matches_jax(cond_pipes):
    """CFG with per-sample scales, per-sample rescale (one row phi=0) and
    a negative class (one row the null id): the final latent and the
    uint8 images of LDMPipeline.sample."""
    jp, up, dp, tp = cond_pipes
    x_t = noise(3)
    kw = dict(condition=np.array([0, 2, 1], np.int32),
              guidance_scale=np.array([1.0, 3.0, 5.0], np.float32),
              cfg_rescale=np.array([0.0, 0.7, 0.0], np.float32),
              negative_condition=np.array([CLASSES, 1, 0], np.int32))
    z_ref, img_ref = jax_sample(jp, up, dp, x_t, 3, **kw)
    img_jax = np.asarray(jp.sample(
        up, dp, jax.random.PRNGKey(1), batch=3, image_size=IMAGE, num_steps=3,
        init_noise=jnp.asarray(x_t), condition=jnp.asarray(kw["condition"]),
        guidance_scales=jnp.asarray(kw["guidance_scale"]),
        cfg_rescales=jnp.asarray(kw["cfg_rescale"]),
        negative_condition=jnp.asarray(kw["negative_condition"])))
    np.testing.assert_array_equal(img_jax, img_ref)
    t = torch.from_numpy
    img, z = tp.sample(batch=3, image_size=IMAGE, num_steps=3, init_noise=t(x_t),
                       condition=t(kw["condition"]), guidance_scales=t(kw["guidance_scale"]),
                       cfg_rescales=t(kw["cfg_rescale"]),
                       negative_condition=t(kw["negative_condition"]),
                       return_latent=True)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert_images_close(img, img_ref)


def test_cfg_scalar_guidance_and_rescale_match_jax(cond_pipes):
    """A scalar guidance scale and rescale (the CLI's flags) with DPM-Solver++."""
    jp, up, dp, tp = cond_pipes
    x_t = noise(2, seed=4)
    cond = np.array([1, 2], np.int32)
    z_ref, img_ref = jax_sample(jp, up, dp, x_t, 3, sampler="dpm++2m", condition=cond,
                                guidance_scale=3.0, cfg_rescale=0.5)
    img, z = tp.sample(batch=2, image_size=IMAGE, num_steps=3, init_noise=torch.from_numpy(x_t),
                       sampler="dpm++2m", condition=torch.from_numpy(cond),
                       guidance_scale=3.0, cfg_rescale=0.5, return_latent=True)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert_images_close(img, img_ref)


@pytest.mark.parametrize("num_steps", [1, 2, 5])
def test_dpm_solver_sample_matches_jax(uncond_pipes, num_steps):
    """DPM-Solver++(2M): the one-step (x0 at once), two-step (first order
    then x0) and multistep branches."""
    jp, up, dp, tp = uncond_pipes
    x_t = noise(2, seed=num_steps)
    z_ref, img_ref = jax_sample(jp, up, dp, x_t, num_steps, sampler="dpm++2m")
    img, z = tp.sample(batch=2, image_size=IMAGE, num_steps=num_steps,
                       init_noise=torch.from_numpy(x_t), sampler="dpm++2m",
                       return_latent=True)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert_images_close(img, img_ref)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++2m"])
def test_deepcache_sample_matches_jax(uncond_pipes, sampler):
    """DeepCache at interval 2: fresh deep core on steps 0, 2, 4, the
    cached one on steps 1 and 3; unlike a plain sample."""
    jp, up, dp, tp = uncond_pipes
    x_t = noise(1, seed=7)
    z_ref, img_ref = jax_sample(jp, up, dp, x_t, 5, sampler=sampler, cache_interval=2)
    run = lambda k: tp.sample(batch=1, image_size=IMAGE, num_steps=5,
                              init_noise=torch.from_numpy(x_t), sampler=sampler,
                              cache_interval=k, return_latent=True)
    img, z = run(2)
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert_images_close(img, img_ref)
    assert not torch.allclose(z, run(1)[1])


def test_cfg_branches_share_one_routing_plan():
    """With drawn routing, each denoise step draws one plan and passes it
    to both CFG branches (the conditional, then the null class)."""
    pipe = LDMPipeline.random(UNetConfig(num_classes=CLASSES).tiny(), VAEConfig().tiny(),
                              dtype=torch.float32, device="cpu", seed=5)
    calls = []
    forward = pipe.unet.forward

    def record(x, t, condition=None, **kw):
        calls.append((kw["moe_plan"].clone(), condition.clone()))
        return forward(x, t, condition, **kw)

    pipe.unet.forward = record
    gen = torch.Generator().manual_seed(0)
    pipe.sample(gen, batch=2, image_size=IMAGE, num_steps=4,
                condition=torch.tensor([0, 2]), guidance_scale=3.0)
    assert len(calls) == 8
    for (plan_c, cond_c), (plan_u, cond_u) in zip(calls[::2], calls[1::2]):
        assert plan_c.shape == (pipe.unet.plan_length(),)
        assert torch.equal(plan_c, plan_u)
        assert cond_c.tolist() == [0, 2] and cond_u.tolist() == [CLASSES] * 2
    plans = {tuple(p.tolist()) for p, _ in calls}
    assert len(plans) > 1  # one draw per step, not one per sample


@pytest.mark.parametrize("kwargs,match", [
    (dict(negative_condition=torch.tensor([1])), "requires a class-conditional"),
    (dict(condition=torch.tensor([0]), negative_condition=torch.tensor([1])),
     "no effect at guidance 1.0"),
    (dict(condition=torch.tensor([0]), guidance_scale=3.0, cache_interval=2),
     "classifier-free guidance"),
    (dict(sampler="euler"), "sampler"),
    (dict(cache_interval=0), "cache_interval"),
])
def test_sample_refuses_bad_arguments(cond_pipes, kwargs, match):
    with pytest.raises(ValueError, match=match):
        cond_pipes[3].sample(batch=1, image_size=IMAGE, num_steps=2,
                             init_noise=torch.zeros(1, 8, 8, 8), **kwargs)


def test_deepcache_refuses_a_one_stage_unet():
    cfg = dataclasses.replace(UNetConfig(**FIXED).tiny(), stages=(1,), channels=(32,))
    pipe = LDMPipeline.random(cfg, VAEConfig().tiny(), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match=">= 2 stages"):
        pipe.sample(batch=1, image_size=IMAGE, num_steps=2, cache_interval=2,
                    init_noise=torch.zeros(1, 8, 8, 8))


@pytest.mark.parametrize("flags,match", [
    (["--mask", "m.png"], "--mask requires --init-image"),
    (["--class-id", "1"], "--class-id requires --num-classes"),
    (["--num-classes", "3", "--negative-class", "1"], "requires --class-id"),
    (["--num-classes", "3", "--class-id", "0", "--negative-class", "1"],
     "no effect at --guidance-scale 1.0"),
    (["--num-classes", "3", "--class-id", "0", "--guidance-scale", "3",
      "--negative-class", "3"], r"must be in \[0, 3\)"),
    (["--init-image", "x.png", "--strength", "0"], r"strength must be in \(0, 1\]"),
    (["--init-image", "x.png", "--mask", "m.png", "--sampler", "dpm++2m"],
     "requires sampler='ddim'"),
])
def test_sample_cli_checks_arguments_in_the_jax_order(flags, match):
    with pytest.raises(SystemExit, match=match):
        sample_ldm.main(["--config", "tiny", "-d", "cpu", *flags])


def test_film_schedule_is_memoized_per_weight_version(monkeypatch):
    """Two samples of unchanged weights collect the FiLM schedule once; an
    in-place parameter change (a new weight version) collects it again;
    another step count is another entry; at most FILM_MEMO_MAX kept."""
    from ldm_image_generator_tpu_torch import pipelines

    unet_cfg = UNetConfig(**FIXED).tiny()
    pipe = LDMPipeline.random(unet_cfg, VAEConfig().tiny(), dtype=torch.float32,
                              device="cpu")
    collected = []
    run = lambda n: pipe.sample(batch=1, image_size=IMAGE, num_steps=n,
                                init_noise=torch.zeros(1, 8, 8, 8))
    collect = UNet.collect_film
    monkeypatch.setattr(UNet, "collect_film", lambda self, t, hw: (
        collected.append(len(t)) or collect(self, t, hw)))
    first = run(2)
    assert torch.equal(run(2), first) and collected == [2]
    with torch.no_grad():
        pipe.unet.dec_stage_0.block_0.encodings.proj2.bias.add_(0.5)
    run(2)
    assert collected == [2, 2]
    run(3)
    run(2)
    assert collected == [2, 2, 3]
    for n in range(4, 4 + pipelines.FILM_MEMO_MAX):
        run(n)
    assert len(pipe._films) == pipelines.FILM_MEMO_MAX
