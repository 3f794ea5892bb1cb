"""The port's pixel-space DDPM against the JAX package (tiny config, CPU,
fp32, 3 input channels, routing pinned to experts (0, 1), 16px, 5
steps): DDPMPipeline (DDIM, DPM-Solver++, DeepCache), the reference-API
DDPM class (loss and sampling, CFG included), one RAdam train step, and
the train_ddpm / sample_ddpm CLIs (JAX-written and other-config files)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.diffusion import ddpm as jddpm
from ldm_image_generator_tpu.diffusion.engine import DDPM as JDDPM
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.pipelines import DDPMPipeline as JDDPMPipeline
from ldm_image_generator_tpu.train import steps as jsteps
from ldm_image_generator_tpu.utils.checkpoint import save_params as jsave
from ldm_image_generator_tpu_torch.cli import sample_ddpm, train_ddpm
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig
from ldm_image_generator_tpu_torch.convert import (
    flatten_tree,
    flax_tree,
    load_flax_file,
    save_flax_file,
)
from ldm_image_generator_tpu_torch.diffusion import ddpm as tddpm
from ldm_image_generator_tpu_torch.diffusion.engine import DDPM
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.pipelines import DDPMPipeline
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-5)
IMAGE = 16   # two stages at 16 and 8: windowed attention at both
STEPS = 5
CLASSES = 3
FIXED = dict(input_channels=3, fixed_expert_indices=(0, 1))
# As in tests/test_torch_port_cond.py: v-prediction keeps every sample
# O(1) under random weights (eps-prediction's x0 divides the UNet's miss
# by sqrt(alpha_bar)), and the output layer is scaled by OUT_GAIN so the
# 5-step samplers do not amplify reordered fp32 sums past the tolerance
PREDICTION = "v"
OUT_GAIN = 0.25
SHAPE = (2, IMAGE, IMAGE, 3)


def seeded_unet(num_classes: int = 0, seed: int = 3, **cfg) -> UNet:
    """A port UNet (tiny, 3 channels, pinned experts) with seeded weights,
    its output layer scaled by OUT_GAIN."""
    ucfg = dataclasses.replace(UNetConfig(num_classes=num_classes, **FIXED).tiny(), **cfg)
    unet = UNet(ucfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        unet.decoder_last.kernel.mul_(OUT_GAIN)
    return unet


def jax_tree(module) -> dict:
    """The module's parameters as JAX arrays, copied: flax_tree's numpy
    arrays share the parameters' memory, which jnp.asarray may alias on
    the CPU, and an asynchronously dispatched JAX step would then read
    parameters that the port's step is updating in place."""
    return jax.tree.map(jnp.array, flax_tree(module))


def jax_x_t(key, shape) -> np.ndarray:
    """x_T as the JAX samplers draw it from their key (ddim_sample,
    dpm_solver_sample): the second half of one split."""
    _, k = jax.random.split(key)
    return np.array(jax.random.normal(k, shape, jnp.float32))


def assert_images_close(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()


@pytest.fixture(scope="module")
def pipes():
    """(JAX DDPMPipeline, its params, the port's on the same weights)."""
    unet = seeded_unet()
    jp = JDDPMPipeline(JUNetConfig(**FIXED).tiny(), JDDPMConfig(prediction=PREDICTION),
                       dtype=jnp.float32)
    tp = DDPMPipeline(unet, DDPMConfig(prediction=PREDICTION), dtype=torch.float32)
    return jp, jax_tree(unet), tp


@pytest.mark.parametrize("sampler,cache", [("ddim", 1), ("dpm++2m", 1), ("ddim", 2)],
                         ids=["ddim", "dpm", "deepcache2"])
def test_ddpm_pipeline_matches_jax(pipes, sampler, cache):
    """DDPMPipeline.sample against the JAX package's with its x_T: uint8
    within one level, with the FiLM schedule memoized and inline."""
    jp, params, tp = pipes
    key = jax.random.PRNGKey(4)
    ref = np.asarray(jp.sample(params, key, batch=2, image_size=IMAGE,
                               num_steps=STEPS, sampler=sampler, cache_interval=cache))
    x_t = torch.from_numpy(jax_x_t(key, SHAPE))
    for film_cache in (True, False):
        got = tp.sample(batch=2, image_size=IMAGE, num_steps=STEPS, sampler=sampler,
                        cache_interval=cache, film_cache=film_cache, init_noise=x_t)
        assert_images_close(got, ref)


def test_ddpm_pipeline_checks_and_random_weights():
    """The argument checks, and random(): seeded weights, a generator
    drawing x_T and one routing plan per step."""
    pipe = DDPMPipeline.random(UNetConfig(input_channels=3).tiny(), device="cpu",
                               dtype=torch.float32, seed=1)
    sample = lambda gen, **kw: pipe.sample(gen, batch=1, image_size=IMAGE,
                                           num_steps=3, **kw)
    a = sample(torch.Generator().manual_seed(2))
    assert a.dtype == torch.uint8 and tuple(a.shape) == (1, IMAGE, IMAGE, 3)
    assert torch.equal(a, sample(torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError, match="sampler 'euler'"):
        sample(torch.Generator(), sampler="euler")
    with pytest.raises(ValueError, match="cache_interval 0"):
        sample(torch.Generator(), cache_interval=0)
    with pytest.raises(ValueError, match="needs a generator"):
        sample(None, init_noise=torch.zeros(1, IMAGE, IMAGE, 3))


@pytest.mark.parametrize("loss,prediction,train,classes", [
    ("l1", "eps", False, 0), ("l2", "v", False, 0), ("l1", "v", True, 0),
    ("l1", "eps", False, CLASSES)], ids=["l1-eps", "l2-v", "train", "cond"])
def test_ddpm_calculate_loss_matches_jax(loss, prediction, train, classes):
    """DDPM.calculate_loss with JAX's t and noise injected against the JAX
    class's (a train forward with stochastic depth 0: no gates to
    draw; class ids for the conditional UNet)."""
    unet = seeded_unet(classes, stochastic_depth=0.0 if train else 0.25)
    jcfg = dataclasses.replace(JUNetConfig(num_classes=classes, **FIXED).tiny(),
                               stochastic_depth=unet.cfg.stochastic_depth)
    kw = dict(loss_function=loss, prediction=prediction,
              zero_terminal_snr=prediction == "v")
    x = np.random.default_rng(6).uniform(-1, 1, SHAPE).astype(np.float32)
    cond = np.array([0, CLASSES], np.int32) if classes else None
    key = jax.random.PRNGKey(7)
    ref = JDDPM(JUNet(jcfg, dtype=jnp.float32), jax_tree(unet), **kw).calculate_loss(
        jnp.asarray(x), key, condition=None if cond is None else jnp.asarray(cond),
        train=train)
    key_t, key_eps, _ = jax.random.split(key, 3)
    t = torch.from_numpy(np.array(jax.random.randint(key_t, (2,), 1, 1000)))
    eps = torch.from_numpy(np.array(jax.random.normal(key_eps, SHAPE)))
    got = DDPM(unet, **kw).calculate_loss(
        torch.from_numpy(x), condition=None if cond is None else torch.from_numpy(cond),
        train=train, t=t, eps=eps)
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


@pytest.mark.parametrize("schedule,guidance", [
    ("linear", 1.0), ((0, 150, 400, 700, 999), 1.0), ("linear", 3.0)],
    ids=["linear", "explicit", "cfg"])
def test_ddpm_sample_matches_jax(schedule, guidance):
    """DDPM.sample against the JAX class's with its x_T injected: a linear
    and an explicit step schedule, and classifier-free guidance on the
    3-class UNet (the unconditional branch without a condition, both
    branches under one plan)."""
    classes = CLASSES if guidance != 1.0 else 0
    unet = seeded_unet(classes, seed=8)
    jd = JDDPM(JUNet(JUNetConfig(num_classes=classes, **FIXED).tiny(), dtype=jnp.float32),
               jax_tree(unet), prediction=PREDICTION)
    cond = np.array([1, 2], np.int32) if classes else None
    ref = jd.sample(SHAPE, condition=None if cond is None else jnp.asarray(cond), seed=5,
                    num_steps=STEPS, schedule=schedule, guidance_scale=guidance)
    x_t = jax_x_t(jax.random.PRNGKey(5), SHAPE)
    got = DDPM(unet, prediction=PREDICTION).sample(
        SHAPE, condition=None if cond is None else torch.from_numpy(cond), seed=5,
        num_steps=STEPS, schedule=schedule, guidance_scale=guidance,
        use_autocast=True, init_noise=torch.from_numpy(x_t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(NotImplementedError, match="cosine"):
        DDPM(unet).sample(SHAPE, schedule="cosine")


def test_ddpm_train_step_matches_jax():
    """One pixel-space train step, RAdam with EMA 0.999 and Min-SNR 5,
    against the JAX package's make_ldm_train_step (jitted, as its
    trainer runs it) with its t and noise injected: the loss, RAdam's
    moments, the parameters and the EMA at the fp32 tolerance."""
    unet = seeded_unet(stochastic_depth=0.0)
    jcfg = dataclasses.replace(JUNetConfig(**FIXED).tiny(), stochastic_depth=0.0)
    params = jax_tree(unet)
    x = np.random.default_rng(9).uniform(-1, 1, SHAPE).astype(np.float32)
    lr, gamma = 1e-3, 5.0
    jtx = jsteps.make_optimizer("radam", lr)
    jstate = jsteps.LDMTrainState(params=params, opt_state=jtx.init(params),
                                  step=jnp.zeros((), jnp.int32),
                                  ema_params=jsteps.init_ema(params))
    jstep = jax.jit(jsteps.make_ldm_train_step(
        JUNet(jcfg, dtype=jnp.float32), jddpm.make_schedule(JDDPMConfig()), jtx,
        ema_decay=0.999, min_snr_gamma=gamma))
    ttx = tsteps.make_optimizer("radam", lr)
    tstate = tsteps.LDMTrainState(params=unet, opt_state=ttx.init(list(unet.parameters())),
                                  ema_params=tsteps.init_ema(unet))
    tstep = tsteps.make_ldm_train_step(unet, tddpm.make_schedule(DDPMConfig()), ttx,
                                       ema_decay=0.999, min_snr_gamma=gamma)
    key = jax.random.PRNGKey(3)
    key_t, key_eps, _ = jax.random.split(key, 3)
    t = torch.from_numpy(np.array(jax.random.randint(key_t, (2,), 1, 1000)))
    eps = torch.from_numpy(np.array(jax.random.normal(key_eps, SHAPE)))
    jstate, jm = jstep(jstate, jnp.asarray(x), key)
    tstate, tm = tstep(tstate, torch.from_numpy(x), t=t, eps=eps)
    assert tstate.step == int(jstate.step) == 1
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
    names = [n for n, _ in unet.named_parameters()]
    flat = lambda tree: flatten_tree(jax.tree.map(np.asarray, tree))
    jmu, jnu = (flat({"params": getattr(jstate.opt_state[0], k)["params"]})
                for k in ("mu", "nu"))
    jparams, jema = flat(jstate.params), flat(jstate.ema_params)
    for i, (name, p) in enumerate(unet.named_parameters()):
        key_ = "params." + name
        np.testing.assert_allclose(tstate.opt_state.mu[i].numpy(), jmu[key_], **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(tstate.opt_state.nu[i].numpy(), jnu[key_],
                                   rtol=5e-4, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), jparams[key_], **TOL, err_msg=name)
        np.testing.assert_allclose(tstate.ema_params[name].numpy(), jema[key_], **TOL,
                                   err_msg=name)
    assert len(names) == len(jparams)


def _images(tmp_path, n=4):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            d / f"{i}.png")
    return str(d)


def test_ddpm_clis_train_resume_and_sample(tmp_path, capsys, monkeypatch):
    """train_ddpm on 4 images writes the model and EMA files (and its
    train state); a rerun resumes from it; sample_ddpm reads the model
    and writes one PNG per image."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    imgs = _images(tmp_path)
    args = [imgs, "-d", "cpu", "--config", "tiny", "-b", "2", "-m", "4", "-s", "16",
            "--ema", "0.999", "--ckpt-dir", "ck", "--min-snr-gamma", "5"]
    state = train_ddpm.main(args + ["-e", "2"])
    out = capsys.readouterr().out
    assert "dataset: 4 images at 16px" in out
    assert "saved ./ddpm.pt, ./ddpm.pt.ema" in out
    assert state.step == 4 and isinstance(state.opt_state, tsteps.AdamWState)
    assert state.opt_state.count == 4
    cfg = UNetConfig(input_channels=3).tiny()
    for path, want in (("ddpm.pt", dict(state.params.named_parameters())),
                       ("ddpm.pt.ema", state.ema_params)):
        got = load_flax_file(UNet(cfg, device="cpu"), str(tmp_path / path))
        for name, p in got.named_parameters():
            assert torch.equal(p, want[name].detach()), (path, name)
    state = train_ddpm.main(args + ["-e", "1"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint: ./ddpm.pt" in out and "Resumed from step 4" in out
    assert state.step == 6
    sample_ddpm.main(["-d", "cpu", "--config", "tiny", "-n", "2", "-t", "3", "-s", "16",
                      "-o", "out", "--sampler", "dpm++2m"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint: ./ddpm.pt" in out and "saved 2 images to out" in out
    for i in range(2):
        with Image.open(tmp_path / "out" / f"{i}.png") as im:
            assert im.size == (16, 16) and im.mode == "RGB"


def test_jax_written_ddpm_file_samples_as_jax(tmp_path, monkeypatch):
    """A DDPM file written by the JAX package's save_params, read through
    sample_ddpm's loader: its sample (routing drawn as the pair (0, 1),
    JAX's x_T) within one uint8 level of the JAX DDPMPipeline's with the
    experts pinned to (0, 1); the CLI writes its PNG."""
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, IMAGE, IMAGE, 3))
    params = jax.jit(JUNet(JUNetConfig(input_channels=3).tiny()).init)(
        {"params": key, "moe": key, "sd": key}, x0, jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * OUT_GAIN if "decoder_last" in jax.tree_util.keystr(path)
        and "kernel" in jax.tree_util.keystr(path) else v, params)
    path = str(tmp_path / "ddpm.pt")
    jsave(path, params)
    jp = JDDPMPipeline(JUNetConfig(**FIXED).tiny(), JDDPMConfig(prediction=PREDICTION),
                       dtype=jnp.float32)
    ref = np.asarray(jp.sample(params, key, batch=1, image_size=IMAGE, num_steps=STEPS))
    flags = ["-dp", path, "-d", "cpu", "--config", "tiny", "-fp16", "false",
             "--prediction", PREDICTION, "-s", str(IMAGE), "-t", str(STEPS)]
    pipe = sample_ddpm.build_pipeline(sample_ddpm.build_parser().parse_args(flags))
    # pair id 0 of pair_table is the experts (0, 1)
    monkeypatch.setattr(UNet, "draw_plan", lambda self, gen: torch.zeros(
        self.plan_length(), dtype=torch.long))
    got = pipe.sample(torch.Generator(), batch=1, image_size=IMAGE, num_steps=STEPS,
                      init_noise=torch.from_numpy(jax_x_t(key, (1, IMAGE, IMAGE, 3))))
    assert_images_close(got, ref)
    sample_ddpm.main(flags + ["-n", "1", "-o", str(tmp_path / "out")])
    assert (tmp_path / "out" / "0.png").stat().st_size > 0


def test_ldm_file_given_to_the_ddpm_clis_exits(tmp_path, monkeypatch):
    """An 8-channel (latent) UNet file at -dp / -mp: both DDPM CLIs exit
    with the JAX CLIs' mismatch message, naming the stem kernel."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "ldm.pt")
    save_flax_file(UNet(UNetConfig().tiny(), device="cpu"), path)
    match = r"does not match this model config \(param encoder_first\.kernel shape"
    with pytest.raises(SystemExit, match=match):
        sample_ddpm.main(["-dp", path, "-d", "cpu", "--config", "tiny", "-n", "1"])
    with pytest.raises(SystemExit, match=match):
        train_ddpm.main([_images(tmp_path), "-mp", path, "-d", "cpu", "--config", "tiny"])


def test_cuda_request_without_card_raises_in_ddpm_clis(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        sample_ddpm.main(["--config", "tiny", "-n", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_ddpm.main([_images(tmp_path), "--config", "tiny"])
