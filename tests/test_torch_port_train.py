"""The port's training slice against the JAX package (CPU, fp32): the
loss, the stochastic-depth gate, the optimizer against optax, four train
steps of the tiny UNet, the VAE Encoder, and the trainer CLI."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.diffusion import ddpm as jddpm
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.models.layers import SwinBlock as JSwinBlock
from ldm_image_generator_tpu.models.vae import Encoder as JEncoder
from ldm_image_generator_tpu.train import steps as jsteps
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import (
    encoder_from_flax,
    flatten_tree,
    load_flax_params,
    unet_from_flax,
)
from ldm_image_generator_tpu_torch.diffusion import ddpm as tddpm
from ldm_image_generator_tpu_torch.models.layers import ParamInit, SwinBlock
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-5)
np_tree = lambda p: jax.tree.map(np.asarray, p)


def _jax_draws(key, b, shape, num_timesteps=1000):
    """The t and eps JAX's ddpm_loss draws from `key`."""
    key_t, key_eps, _ = jax.random.split(key, 3)
    t = jax.random.randint(key_t, (b,), 1, num_timesteps)
    eps = jax.random.normal(key_eps, shape)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("prediction,loss,gamma", [
    ("eps", "l1", None), ("eps", "l2", None), ("v", "l1", None),
    ("v", "l2", 5.0), ("eps", "l1", 5.0)])
def test_ddpm_loss_matches_jax(prediction, loss, gamma):
    cfg = dict(prediction=prediction, zero_terminal_snr=prediction == "v")
    jsched = jddpm.make_schedule(JDDPMConfig(**cfg))
    tsched = tddpm.make_schedule(DDPMConfig(**cfg))
    x = np.random.default_rng(0).normal(size=(3, 4, 4, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    scale = lambda t: 0.5 + t / 1000.0
    ref = jddpm.ddpm_loss(
        lambda xt, t, k: xt * scale(t)[:, None, None, None], jsched,
        jnp.asarray(x), key, loss=loss, prediction=prediction,
        min_snr_gamma=gamma)
    t, eps = _jax_draws(key, 3, x.shape)
    got = tddpm.ddpm_loss(
        lambda xt, t: xt * scale(t.float())[:, None, None, None], tsched,
        torch.from_numpy(x), loss=loss, prediction=prediction,
        min_snr_gamma=gamma, t=t, eps=eps)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    xt = tddpm.q_sample(tsched, torch.from_numpy(x), t, eps)
    ref_xt = jddpm.q_sample(jsched, jnp.asarray(x), jnp.asarray(t.numpy()),
                            jnp.asarray(eps.numpy()))
    np.testing.assert_allclose(xt.numpy(), np.asarray(ref_xt), rtol=1e-6, atol=1e-7)


def test_ddpm_loss_draws_from_the_generator():
    sched = tddpm.make_schedule(DDPMConfig())
    x = torch.zeros(4, 2, 2, 8)
    seen = []
    fn = lambda xt, t: seen.append(t) or xt
    a = tddpm.ddpm_loss(fn, sched, x, generator=torch.Generator().manual_seed(1))
    b = tddpm.ddpm_loss(fn, sched, x, generator=torch.Generator().manual_seed(1))
    assert a.item() == b.item() and torch.equal(seen[0], seen[1])
    assert ((seen[0] >= 1) & (seen[0] < 1000)).all()


def test_stochastic_depth_gate_matches_jax():
    """JAX draws the gate inside the block; a block that returned its
    input was skipped. Inject each gate JAX drew into the port's block
    and compare the outputs, both gate values seen."""
    c = 32
    jblock = JSwinBlock(c, attention=True, stochastic_depth=0.5,
                        fixed_expert_indices=(0, 1))
    x = np.random.default_rng(1).normal(size=(2, 8, 8, c)).astype(np.float32)
    t = jnp.asarray([10, 700], jnp.int32)
    key = jax.random.PRNGKey(0)
    params = jblock.init({"params": key, "sd": key}, jnp.asarray(x), t)
    tblock = SwinBlock(c, ParamInit("cpu"), attention=True,
                       fixed_expert_indices=(0, 1))
    load_flax_params(tblock, np_tree(params))
    seen = set()
    for i in range(12):
        out = np.asarray(jblock.apply(params, jnp.asarray(x), t, deterministic=False,
                                      rngs={"sd": jax.random.PRNGKey(i)}))
        keep = not np.array_equal(out, x)
        got = tblock(torch.from_numpy(x), torch.from_numpy(np.asarray(t)),
                     gate=torch.tensor(keep))
        np.testing.assert_allclose(got.detach().numpy(), out, **TOL)
        seen.add(keep)
    assert seen == {True, False}


def _sequences(seed, shapes, steps):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 0.1).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    for g in grads:
        g[-1][...] = 0.0  # a parameter the loss never reaches still decays
    return params, grads


@pytest.mark.parametrize("kw", [
    dict(),
    dict(grad_clip=0.5),
    dict(lr_schedule="cosine", warmup_steps=2, total_steps=7),
    dict(lr_schedule="constant", warmup_steps=3),
    dict(accumulate=3, grad_clip=0.5, lr_schedule="cosine", warmup_steps=1,
         total_steps=4),
    # 8 steps: RAdam's bias-corrected momentum on steps 1-5, its
    # rectified update from step 6 (rho >= 5)
    dict(name="radam", steps=8, grad_clip=0.5, lr_schedule="cosine",
         warmup_steps=2, total_steps=9),
], ids=["adamw", "clip", "warmup-cosine", "warmup", "multisteps", "radam"])
def test_optimizer_matches_optax(kw):
    """The port's optimizer against optax's jitted update, as the JAX
    trainers run it (outside jit optax raises b**t for a concrete t by
    repeated products, not XLA's pow)."""
    kw = dict(kw)
    name, steps = kw.pop("name", "adamw"), kw.pop("steps", 7)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params, grads = _sequences(0, shapes, steps=steps)
    jtx = jsteps.make_optimizer(name, 1e-2, **kw)
    jupdate = jax.jit(jtx.update)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    ttx = tsteps.make_optimizer(name, 1e-2, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tp)
    if name == "radam":
        rect = [ttx.rectifier(t) is not None for t in range(1, steps + 1)]
        assert rect == [False] * 5 + [True] * (steps - 5)
    for g in grads:
        upd, jstate = jupdate([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = ttx.apply(tp, [torch.from_numpy(a) for a in g], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def _torch_optimizer_vs_optax(name: str, make, steps: int) -> float:
    """max |torch.optim - optax| over (atol + rtol |optax|) of the
    optimizer test's tolerance, over `steps` steps of its sequence."""
    params, grads = _sequences(0, [(3, 4), (5,), (2, 2, 3)], steps=steps)
    jtx = jsteps.make_optimizer(name, 1e-2)
    jupdate = jax.jit(jtx.update)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = make(tp)
    worst = 0.0
    for g in grads:
        upd, jstate = jupdate([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for a, b in zip(tp, jp):
            b = np.asarray(b)
            worst = max(worst, float((np.abs(a.numpy() - b)
                                      / (1e-7 + 1e-6 * np.abs(b))).max()))
    return worst


def test_torch_adamw_leaves_optax():
    """Why the port writes AdamW out: torch.optim.AdamW (fused here)
    forms the bias corrections 1 - b**t in float64 where optax uses
    float32, and on the sequence of test_optimizer_matches_optax[adamw]
    it leaves optax beyond that test's tolerance."""
    worst = _torch_optimizer_vs_optax("adamw", lambda tp: torch.optim.AdamW(
        tp, lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4,
        fused=True), steps=7)
    print(f"torch.optim.AdamW(fused=True) vs optax: {worst:.2f}x the tolerance")
    assert worst > 1.0


def test_torch_radam_leaves_optax():
    """Why the port writes RAdam out: torch.optim.RAdam forms rho and the
    bias corrections in float64, adds eps before scaling by sqrt(1 -
    b2**t) and rectifies at rho > 5; over 8 steps (two rectified) of the
    optimizer test's sequence it leaves optax.radam beyond that test's
    tolerance."""
    worst = _torch_optimizer_vs_optax("radam", lambda tp: torch.optim.RAdam(
        tp, lr=1e-2, betas=(0.9, 0.999), eps=1e-8), steps=8)
    print(f"torch.optim.RAdam vs optax: {worst:.2f}x the tolerance")
    assert worst > 1.0


def test_lr_schedules_match_optax():
    for args in [(1e-3, "cosine", 5, 50), (1e-3, "constant", 5, 0),
                 (3e-4, "cosine", 0, 20)]:
        j, t = jsteps.make_lr_schedule(*args), tsteps.make_lr_schedule(*args)
        for count in range(0, 60, 3):
            np.testing.assert_allclose(t(count), float(j(jnp.int32(count))),
                                       rtol=1e-6)
    assert tsteps.make_lr_schedule(1e-4) == 1e-4
    with pytest.raises(ValueError):
        tsteps.make_lr_schedule(1e-4, "cosine", 5, 5)
    assert isinstance(tsteps.make_optimizer("radam"), tsteps.RAdam)
    with pytest.raises(ValueError):
        tsteps.make_optimizer("sgd")


def _jax_ema(e, p, step, decay):
    """The JAX train step's EMA update (ldm_image_generator_tpu/train/
    steps.py, make_ldm_train_step), on one array."""
    step_f = jnp.asarray(step, jnp.int32).astype(jnp.float32)
    d = jnp.minimum(decay, (1.0 + step_f) / (10.0 + step_f))
    return e * d + p.astype(e.dtype) * (1.0 - d)


@pytest.mark.parametrize("decay", [0.999, 0.5])
def test_ema_update_matches_jax(decay):
    """ema_update over 12 steps of parameters that move by an Adam-sized
    step each time, against the JAX formula at rtol 1e-6: the warmup
    min(decay, (1 + step) / (10 + step)) read at the count before the
    increment (decay 0.5 caps it from step 8 on)."""
    rng = np.random.default_rng(4)
    params = [rng.normal(size=s).astype(np.float32) for s in [(3, 4), (5,), (64, 64)]]
    j_ema = [jnp.asarray(p) for p in params]
    t_ema = [torch.from_numpy(p.copy()) for p in params]
    for step in range(12):
        params = [(p + 1e-3 * rng.normal(size=p.shape)).astype(np.float32)
                  for p in params]
        j_ema = [_jax_ema(e, jnp.asarray(p), step, decay) for e, p in zip(j_ema, params)]
        tsteps.ema_update(t_ema, [torch.from_numpy(p) for p in params], step, decay)
        for a, b in zip(t_ema, j_ema):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


LATENT = 8
STEPS = 4
LR = 1e-3
# an element whose gradient in the JAX step was within GRAD_ZERO of 0
# (Adam's step of about lr then points where rounding says; exact zeros
# on both sides are compared), or left the port's by more than GRAD_ATOL
# + GRAD_RTOL of itself, is exempt from that step's elementwise check of
# params and EMA. In the first three steps the JAX step's gradient and
# the port's differ by at most 7.0e-7 (rounding); in the fourth the JAX
# step's compilation decides a ReLU boundary apart from the port and
# from an eager jax.grad (2.1e-3 there), and the changed cotangent moves
# many elements upstream by a little
GRAD_ZERO = 1e-5
GRAD_ATOL = 1e-6
GRAD_RTOL = 1e-2
# ...and at most this share of the elements may be exempt in a step
# (0.7-1.1% in the first three steps, 5.5% in the fourth)
EXEMPT_SHARE = 0.1


def test_four_train_steps_match_jax():
    """make_ldm_train_step, tiny config, routing pinned, no stochastic
    depth, t and noise drawn by JAX and injected. Before each of 4 steps
    the port takes the JAX state (params, Adam moments, EMA), so that
    fp32 rounding cannot carry one run away from the other; after it,
    the loss, and params and EMA elementwise, match the JAX step at the
    fp32 tolerance (the first step's gradients too, against an eager
    jax.grad). The gradient the JAX step applied is read back from its
    Adam first moment; elements where it was within rounding of 0 or
    left the port's by more than rounding (GRAD_ZERO, GRAD_ATOL,
    GRAD_RTOL) are
    exempt in that step, and are few (EXEMPT_SHARE)."""
    jcfg = dataclasses.replace(JUNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                               stochastic_depth=0.0)
    tcfg = dataclasses.replace(UNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                               stochastic_depth=0.0)
    junet = JUNet(jcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(2).normal(size=(2, LATENT, LATENT, 8)).astype(np.float32)
    params = jax.jit(junet.init)({"params": key, "moe": key, "sd": key},
                                 jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32))
    jsched = jddpm.make_schedule(JDDPMConfig())
    jtx = jsteps.make_optimizer("adamw", LR)
    jstate = jsteps.LDMTrainState(params=params, opt_state=jtx.init(params),
                                  step=jnp.zeros((), jnp.int32),
                                  ema_params=jsteps.init_ema(params))
    jstep = jax.jit(jsteps.make_ldm_train_step(junet, jsched, jtx, ema_decay=0.9))

    tunet = unet_from_flax(np_tree(params), tcfg, device="cpu")
    ttx = tsteps.make_optimizer("adamw", LR)
    tstate = tsteps.LDMTrainState(params=tunet, opt_state=ttx.init(list(tunet.parameters())),
                                  ema_params=tsteps.init_ema(tunet))
    tstep = tsteps.make_ldm_train_step(tunet, tddpm.make_schedule(DDPMConfig()),
                                       ttx, ema_decay=0.9)
    names = [n for n, _ in tunet.named_parameters()]

    def jloss(p, k):
        def denoise(xt, t, kk):
            return junet.apply(p, xt, t, deterministic=False,
                               rngs={"moe": kk, "sd": kk}).astype(jnp.float32)
        return jddpm.ddpm_loss(denoise, jsched, jnp.asarray(x), k)

    flat = lambda tree: flatten_tree(np_tree(tree)["params"])

    def take_jax_state(js):
        load_flax_params(tunet, np_tree(js.params))
        mu, nu, ema = flat(js.opt_state[0].mu), flat(js.opt_state[0].nu), flat(js.ema_params)
        with torch.no_grad():
            for n, m, v in zip(names, tstate.opt_state.mu, tstate.opt_state.nu):
                m.copy_(torch.from_numpy(mu[n]))
                v.copy_(torch.from_numpy(nu[n]))
            for n, e in tstate.ema_params.items():
                e.copy_(torch.from_numpy(ema[n]))

    for i in range(STEPS):
        k = jax.random.fold_in(key, i)
        t, eps = _jax_draws(k, 2, x.shape)
        take_jax_state(jstate)
        mu_before = flat(jstate.opt_state[0].mu)
        if i == 0:
            ref_loss, ref_grads = jax.value_and_grad(jloss)(jstate.params, k)
        jstate, jm = jstep(jstate, jnp.asarray(x), k)
        tstate, tm = tstep(tstate, torch.from_numpy(x), t=t, eps=eps)
        assert tstate.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
        got = {n: p.grad.numpy() for n, p in tunet.named_parameters()}
        if i == 0:
            np.testing.assert_allclose(float(jm["loss"]), float(ref_loss), rtol=1e-6)
            ref = flat(ref_grads)
            assert set(got) == set(ref)
            for n in ref:
                np.testing.assert_allclose(got[n], ref[n], err_msg=n, **TOL)
        exempt = {}
        for n, m in flat(jstate.opt_state[0].mu).items():  # m = 0.1 g + 0.9 mu
            g_jax = (m.astype(np.float64) - 0.9 * mu_before[n]) / 0.1
            zero = (np.abs(g_jax) <= GRAD_ZERO) & ~((g_jax == 0) & (got[n] == 0))
            exempt[n] = zero | (np.abs(got[n] - g_jax) > GRAD_ATOL + GRAD_RTOL * np.abs(g_jax))
        n_exempt = sum(int(e.sum()) for e in exempt.values())
        n_all = sum(e.size for e in exempt.values())
        assert n_exempt <= EXEMPT_SHARE * n_all, (i, n_exempt, n_all)
        for what, ours, theirs in (
                ("params", dict(tunet.named_parameters()), flat(jstate.params)),
                ("ema", tstate.ema_params, flat(jstate.ema_params))):
            for n, v in theirs.items():
                keep = ~exempt[n]
                np.testing.assert_allclose(ours[n].detach().numpy()[keep], v[keep],
                                           err_msg=f"step {i} {what} {n}", **TOL)


def test_encoder_matches_jax():
    jcfg, tcfg = JVAEConfig().tiny(), VAEConfig().tiny()
    x = np.random.default_rng(3).uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    enc = JEncoder(jcfg)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(enc.apply(params, jnp.asarray(x)))
    port = encoder_from_flax(np_tree(params), tcfg, device="cpu")
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, ref, **TOL)


def _images(tmp_path, n=4):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            d / f"{i}.png")
    return str(d)


def test_train_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    from ldm_image_generator_tpu_torch.cli import train_ldm

    monkeypatch.chdir(tmp_path)
    imgs = _images(tmp_path)
    state = train_ldm.main([imgs, "--config", "tiny", "-s", "32", "-b", "2",
                            "-e", "5", "-d", "cpu", "--ema", "0.999",
                            "--grad-clip", "1.0", "-bm", "2",
                            "--lr-schedule", "cosine", "--warmup-steps", "1",
                            "--total-steps", "8", "--prediction", "v",
                            "--zero-snr", "--min-snr-gamma", "5"])
    out = capsys.readouterr().out
    assert "dataset: 4 latents (16px, 8ch)" in out
    assert "saved ./ddpm.pt, ./ddpm.pt.ema" in out
    assert (tmp_path / "ddpm.pt").stat().st_size > 0
    assert (tmp_path / "ddpm.pt.ema").stat().st_size > 0
    # the JSON metric lines come every 10 steps
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [r["step"] for r in records] == [10]
    assert set(records[0]) == {"step", "time", "loss", "steps_per_s", "images_per_s"}
    assert np.isfinite(records[0]["loss"])
    assert state.step == 10 and state.opt_state.gradient_step == 5
    assert all(torch.isfinite(p).all() for p in state.params.parameters())


@pytest.mark.parametrize("flags,item", [
    (["--fused-steps", "2", "--pipeline-stages", "2"], "cannot be combined"),
    (["-b", "3", "--pipeline-stages", "2"], "must split into 2 microbatches"),
    (["--zero1"], "--zero1 ignored: no data-parallel mesh engaged"),
    (["-ep", "enc.pt"], "A12")])
def test_train_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys, flags, item):
    """The JAX trainer's argument errors, in its words: --fused-steps
    with --pipeline-stages, a batch that does not split into the
    microbatches, and --zero1 without data parallelism (a line, not an
    exit; A13 ported all three flags). A reference (torch) encoder file,
    which the trainer refused until A12 ported the converters: made by
    the JAX package's torch_export from seeded weights, it loads through
    the CLI into the encoder that makes the latents, exactly those
    weights."""
    from ldm_image_generator_tpu.utils import torch_export as jte
    from ldm_image_generator_tpu_torch.cli import train_ldm
    from ldm_image_generator_tpu_torch.convert import flax_tree
    from ldm_image_generator_tpu_torch.models.vae import Encoder

    monkeypatch.chdir(tmp_path)
    if "--zero1" in flags:
        train_ldm.main([_images(tmp_path), "-d", "cpu", "--config", "tiny", "-s", "32",
                        "-b", "2", "-e", "0", *flags])
        assert item in capsys.readouterr().out
        return
    if item != "A12":
        with pytest.raises(SystemExit, match=item):
            train_ldm.main([str(tmp_path), "-d", "cpu", *flags])
        return
    want = Encoder(VAEConfig().tiny(), device="cpu",
                   generator=torch.Generator().manual_seed(7))
    jte.save_state_dict(str(tmp_path / "enc.pt"),
                        jte.export_encoder(flax_tree(want), JVAEConfig().tiny()))
    loaded = {}
    load = train_ldm.maybe_load

    def spy(module, path, converter=None):
        loaded[path] = module
        return load(module, path, converter)

    monkeypatch.setattr(train_ldm, "maybe_load", spy)
    train_ldm.main([_images(tmp_path), "-d", "cpu", "--config", "tiny", "-s", "32",
                    "-b", "2", "-e", "0", *flags])
    got = loaded["enc.pt"].state_dict()
    assert got.keys() == want.state_dict().keys()
    for name, w in want.state_dict().items():
        assert torch.equal(got[name], w), name


def test_cuda_request_without_card_raises_in_trainer(tmp_path, monkeypatch):
    from ldm_image_generator_tpu_torch.cli import train_ldm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        train_ldm.main([_images(tmp_path), "--config", "tiny", "-s", "32"])
