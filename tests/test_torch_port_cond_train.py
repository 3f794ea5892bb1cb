"""The port's class-conditional training and its companions against the
JAX package (tiny config, CPU, fp32): conditional train steps with
labels and dropped class ids, the validator, fused steps, remat, the
loader's order and labels, and --num-classes in the trainer CLI."""
import dataclasses
import io
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.data.loader import BatchLoader as JBatchLoader
from ldm_image_generator_tpu.diffusion import ddpm as jddpm
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.train import steps as jsteps
from ldm_image_generator_tpu.train.eval import Validator as JValidator
from ldm_image_generator_tpu_torch.cli import train_ldm
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig
from ldm_image_generator_tpu_torch.convert import (
    flatten_tree,
    load_flax_params,
    unet_from_flax,
)
from ldm_image_generator_tpu_torch.data.loader import BatchLoader
from ldm_image_generator_tpu_torch.diffusion import ddpm as tddpm
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.train import steps as tsteps
from ldm_image_generator_tpu_torch.train.eval import Validator, eval_timesteps
from ldm_image_generator_tpu_torch.utils.metrics import MetricLogger

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-5)
np_tree = lambda p: jax.tree.map(np.asarray, p)
LATENT = 8
CLASSES = 3
LR = 1e-3
FIXED = dict(fixed_expert_indices=(0, 1))
# the exemption rule of tests/test_torch_port_train.py's four-step test:
# an element whose JAX-step gradient was within GRAD_ZERO of 0, or left
# the port's by more than GRAD_ATOL + GRAD_RTOL of itself, is exempt
# from that step's elementwise check, and at most EXEMPT_SHARE are
GRAD_ZERO = 1e-5
GRAD_ATOL = 1e-6
GRAD_RTOL = 1e-2
EXEMPT_SHARE = 0.1


def _jax_draws(key, b, shape, num_timesteps=1000):
    """The t and eps JAX's ddpm_loss draws from `key`."""
    key_t, key_eps, _ = jax.random.split(key, 3)
    t = jax.random.randint(key_t, (b,), 1, num_timesteps)
    eps = jax.random.normal(key_eps, shape)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


def _jax_cond(key, labels, cond_drop):
    """The class ids JAX's train step conditions on: each label replaced
    by the null class where uniform(fold_in(key, 0x5EED)) < cond_drop."""
    drop = jax.random.uniform(jax.random.fold_in(key, 0x5EED), labels.shape) < cond_drop
    return np.asarray(jnp.where(drop, CLASSES, jnp.asarray(labels)).astype(jnp.int32))


def _jax_unet(cfg, x, **over):
    junet = JUNet(dataclasses.replace(cfg, **over), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = jax.jit(junet.init)({"params": key, "moe": key, "sd": key},
                                 jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32))
    return junet, params


def test_three_conditional_train_steps_match_jax():
    """make_ldm_train_step with num_classes=3 and labels, cond_drop 0.5,
    routing pinned, no stochastic depth: t, noise and the class ids after
    JAX's drop injected (some rows dropped to the null class). Before each
    of 3 steps the port takes the JAX state; after it the loss, and params
    and EMA elementwise (the exemption rule above), match the JAX step,
    and the first step's gradients (class table and cross-attention
    included) the JAX step's, read back from its Adam first moment."""
    jcfg = dataclasses.replace(JUNetConfig(num_classes=CLASSES, **FIXED).tiny(),
                               stochastic_depth=0.0)
    tcfg = dataclasses.replace(UNetConfig(num_classes=CLASSES, **FIXED).tiny(),
                               stochastic_depth=0.0)
    x = np.random.default_rng(2).normal(size=(4, LATENT, LATENT, 8)).astype(np.float32)
    labels = np.array([0, 1, 2, 1], np.int32)
    junet, params = _jax_unet(jcfg, x)
    key = jax.random.PRNGKey(0)
    jsched = jddpm.make_schedule(JDDPMConfig())
    jtx = jsteps.make_optimizer("adamw", LR)
    jstate = jsteps.LDMTrainState(params=params, opt_state=jtx.init(params),
                                  step=jnp.zeros((), jnp.int32),
                                  ema_params=jsteps.init_ema(params))
    jstep = jax.jit(jsteps.make_ldm_train_step(junet, jsched, jtx, ema_decay=0.9,
                                               num_classes=CLASSES, cond_drop=0.5))
    tunet = unet_from_flax(np_tree(params), tcfg, device="cpu")
    ttx = tsteps.make_optimizer("adamw", LR)
    tstate = tsteps.LDMTrainState(params=tunet, opt_state=ttx.init(list(tunet.parameters())),
                                  ema_params=tsteps.init_ema(tunet))
    tstep = tsteps.make_ldm_train_step(tunet, tddpm.make_schedule(DDPMConfig()), ttx,
                                       ema_decay=0.9, num_classes=CLASSES, cond_drop=0.5)
    names = [n for n, _ in tunet.named_parameters()]
    flat = lambda tree: flatten_tree(np_tree(tree)["params"])

    dropped = 0
    for i in range(3):
        k = jax.random.fold_in(key, i)
        t, eps = _jax_draws(k, 4, x.shape)
        cond = _jax_cond(k, labels, 0.5)
        dropped += int((cond == CLASSES).sum())
        load_flax_params(tunet, np_tree(jstate.params))
        mu, nu, ema = (flat(jstate.opt_state[0].mu), flat(jstate.opt_state[0].nu),
                       flat(jstate.ema_params))
        with torch.no_grad():
            for n, m, v in zip(names, tstate.opt_state.mu, tstate.opt_state.nu):
                m.copy_(torch.from_numpy(mu[n]))
                v.copy_(torch.from_numpy(nu[n]))
            for n, e in tstate.ema_params.items():
                e.copy_(torch.from_numpy(ema[n]))
        jstate, jm = jstep(jstate, jnp.asarray(x), k, jnp.asarray(labels))
        tstate, tm = tstep(tstate, torch.from_numpy(x), t=t, eps=eps,
                           cond=torch.from_numpy(cond))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
        got = {n: p.grad.numpy() for n, p in tunet.named_parameters()}
        exempt = {}
        for n, m in flat(jstate.opt_state[0].mu).items():  # m = 0.1 g + 0.9 mu
            g_jax = (m.astype(np.float64) - 0.9 * mu[n]) / 0.1
            if i == 0:  # mu was 0: g_jax is the JAX step's gradient
                np.testing.assert_allclose(got[n], g_jax, err_msg=n, **TOL)
            zero = (np.abs(g_jax) <= GRAD_ZERO) & ~((g_jax == 0) & (got[n] == 0))
            exempt[n] = zero | (np.abs(got[n] - g_jax) > GRAD_ATOL + GRAD_RTOL * np.abs(g_jax))
        n_exempt = sum(int(e.sum()) for e in exempt.values())
        assert n_exempt <= EXEMPT_SHARE * sum(e.size for e in exempt.values()), i
        for what, ours, theirs in (
                ("params", dict(tunet.named_parameters()), flat(jstate.params)),
                ("ema", tstate.ema_params, flat(jstate.ema_params))):
            for n, v in theirs.items():
                keep = ~exempt[n]
                np.testing.assert_allclose(ours[n].detach().numpy()[keep], v[keep],
                                           err_msg=f"step {i} {what} {n}", **TOL)
        if i == 0:
            assert set(got) == set(exempt)
            assert np.abs(got["class_embed.embedding"]).max() > 0
            assert any("cross_attention" in n for n in got)
    assert 0 < dropped < 12


def test_labels_drop_draw_and_unconditional_stream():
    """With labels the step draws one uniform per label first and drops
    about cond_drop of them to the null class; without labels (or with
    class ids injected) it draws exactly what an unconditional step
    draws, so the unconditional step is unchanged."""
    cfg = UNetConfig(num_classes=CLASSES).tiny()
    x = torch.randn(2, LATENT, LATENT, 8, generator=torch.Generator().manual_seed(0))

    def run(num_classes, **kw):
        gen = torch.Generator().manual_seed(7)
        unet = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        tx = tsteps.make_optimizer("adamw", LR)
        state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())))
        seen = []
        forward = unet.forward
        unet.forward = lambda *a, **k: seen.append(a[2]) or forward(*a, **k)
        step = tsteps.make_ldm_train_step(unet, tddpm.make_schedule(DDPMConfig()), tx,
                                          num_classes=num_classes, cond_drop=0.5)
        _, m = step(state, x, generator=gen, **kw)
        return m["loss"].item(), gen.get_state(), seen[0]

    base = run(0)
    assert base[2] is None
    for kw in (dict(), dict(labels=None)):
        loss, gstate, cond = run(CLASSES, **kw)
        assert loss == base[0] and torch.equal(gstate, base[1]) and cond is None
    loss, gstate, cond = run(CLASSES, cond=torch.tensor([2, CLASSES]))
    assert torch.equal(gstate, base[1]) and cond.tolist() == [2, CLASSES]
    loss, gstate, cond = run(CLASSES, labels=torch.tensor([0, 1]))
    u = torch.rand(2, generator=torch.Generator().manual_seed(7))
    assert cond.tolist() == torch.where(u < 0.5, CLASSES, torch.tensor([0, 1])).tolist()
    assert not torch.equal(gstate, base[1])


class _Latents:
    """An in-memory dataset of seeded latents with per-item labels."""

    def __init__(self, n: int, seed: int = 0, classes: int = CLASSES):
        rng = np.random.default_rng(seed)
        self.items = rng.normal(size=(n, LATENT, LATENT, 8)).astype(np.float32)
        self.labels = [i % classes for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("num_classes,prediction,loss", [
    (0, "eps", "l1"), (CLASSES, "v", "l2")])
def test_validator_matches_jax(num_classes, prediction, loss):
    """Validator.run for the parameters and an EMA, against JAX's, with
    the same noise per batch injected (routing pinned): 5 items at batch
    2 make 2 batches; a conditional UNet is evaluated unconditioned."""
    jcfg = JUNetConfig(num_classes=num_classes, **FIXED).tiny()
    tcfg = UNetConfig(num_classes=num_classes, **FIXED).tiny()
    ds = _Latents(5)
    junet, params = _jax_unet(jcfg, ds.items)
    ema = jax.tree.map(lambda p: p * 0.9, params)
    jsched = jddpm.make_schedule(JDDPMConfig(prediction=prediction,
                                             zero_terminal_snr=prediction == "v"))
    jval = JValidator(ds, junet, jsched, prediction=prediction, loss=loss, batch=2,
                      max_batches=4)
    want = jval.run(jsteps.LDMTrainState(params=params, opt_state=None, step=0,
                                         ema_params=ema))
    key = jax.random.PRNGKey(1234)
    draws = [(torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i),
                                                          (2, LATENT, LATENT, 8)))),
              [None] * 8) for i in range(2)]
    tunet = unet_from_flax(np_tree(params), tcfg, device="cpu")
    tsched = tddpm.make_schedule(DDPMConfig(prediction=prediction,
                                            zero_terminal_snr=prediction == "v"))
    tval = Validator(ds, tunet, tsched, prediction=prediction, loss=loss, batch=2,
                     max_batches=4, draws=draws)
    assert len(tval.batches) == len(jval.batches) == 2
    tema = {n: torch.from_numpy(v) for n, v in flatten_tree(np_tree(ema)["params"]).items()}
    got = tval.run(tsteps.LDMTrainState(params=tunet, opt_state=None, ema_params=tema))
    assert set(got) == set(want) == {"val_loss", "val_loss_ema"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["val_loss"] != got["val_loss_ema"]
    assert eval_timesteps(tsched, 8) == np.asarray(
        jnp.linspace(1, 999, 8).astype(jnp.int32)).tolist()
    assert tval.run(tsteps.LDMTrainState(params=tunet, opt_state=None)) == {
        "val_loss": got["val_loss"]}


def test_validator_draws_its_own_plans_once():
    """Drawn routing: one plan per grid point and batch, from the
    Validator's own seeded generator, drawn once: the loss repeats, and
    two Validators agree; every call is deterministic (no gates)."""
    unet = UNet(UNetConfig().tiny(), device="cpu", generator=torch.Generator().manual_seed(0))
    ds = _Latents(4)
    sched = tddpm.make_schedule(DDPMConfig())
    calls = []
    forward = unet.forward
    unet.forward = lambda *a, **k: calls.append(k) or forward(*a, **k)
    val = Validator(ds, unet, sched, batch=2, max_batches=2)
    first = val.run(tsteps.LDMTrainState(params=unet, opt_state=None))
    assert len(calls) == 16 and all(k["deterministic"] for k in calls)
    plans = {tuple(k["moe_plan"].tolist()) for k in calls}
    assert len(plans) > 1
    assert val.run(tsteps.LDMTrainState(params=unet, opt_state=None)) == first
    again = Validator(ds, unet, sched, batch=2, max_batches=2)
    assert again.run(tsteps.LDMTrainState(params=unet, opt_state=None)) == first


def _cli_images(tmp_path, dirs=("imgs",), n=4):
    from PIL import Image

    rng = np.random.default_rng(0)
    out = []
    for name in dirs:
        d = tmp_path / name
        d.mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                d / f"{i}.png")
        out.append(str(d))
    return out


CLI = ["--config", "tiny", "-s", "32", "-b", "2", "-d", "cpu", "--ema", "0.999"]


def test_fused_steps_are_bitwise_single_steps(tmp_path, monkeypatch, capsys):
    """--fused-steps 3 over 4 batches an epoch (one group of 3, one
    batch unfused at the epoch's end) ends bitwise where single steps
    end: parameters, Adam moments, EMA and step count."""
    monkeypatch.chdir(tmp_path)
    imgs = _cli_images(tmp_path, n=8)
    runs = {n: train_ldm.main(imgs + CLI + ["-e", "2", "--fused-steps", str(n),
                                            "-mp", f"m{n}.pt"])
            for n in (1, 3)}
    out = capsys.readouterr().out
    assert "fused-steps: 3 train steps per group" in out and "warning" not in out
    a, b = runs[1], runs[3]
    assert a.step == b.step == 8
    for (n, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), n
    for x, y in zip(a.opt_state.mu + a.opt_state.nu + list(a.ema_params.values()),
                    b.opt_state.mu + b.opt_state.nu + list(b.ema_params.values())):
        assert torch.equal(x, y)


@pytest.mark.parametrize("batches,fused,groups,flushed,warned", [
    (4, 3, 1, 1, False), (2, 3, 0, 2, True), (6, 3, 2, 0, False), (5, 1, 5, 0, False)])
def test_fused_groups_and_epoch_end_flush(capsys, batches, fused, groups, flushed, warned):
    """Per epoch: len // fused groups (metrics with <k>_gmax), the rest
    run unfused at the epoch's end, with the JAX trainer's warning when
    the epoch is shorter than one group."""
    @dataclasses.dataclass
    class Stub:
        step: int = 0

    calls = []

    def step(state, item):
        calls.append(item)
        return Stub(state.step + 1), {"loss": torch.tensor(float(state.step))}

    out = io.StringIO()
    state = train_ldm.train_loop(Stub(), step, list(range(batches)), epochs=2,
                                 batch_size=2, save_all=lambda s: None,
                                 fused_steps=fused,
                                 logger=MetricLogger(log_every=1, stream=out))
    assert state.step == 2 * batches and calls == list(range(batches)) * 2
    recs = [line for line in out.getvalue().splitlines()]
    with_gmax = [r for r in recs if "loss_gmax" in r]
    assert len(with_gmax) == 2 * groups * (fused > 1)
    assert len(recs) - len(with_gmax) == 2 * (flushed + (groups if fused == 1 else 0))
    assert ("warning: epoch yielded" in capsys.readouterr().out) == warned


def test_remat_gradients_match_plain_and_jax():
    """remat=True: one train step with drawn t, noise, routing and gates
    gives the loss and every gradient bitwise as without remat, and
    leaves the generator where the plain step does (a draw inside a
    rematerialized stack would be drawn again in the recompute and fail
    both); its gradients match JAX's remat=True UNet (eager jax.grad,
    same injected draws) at the fp32 tolerance."""
    cfg = UNetConfig(num_classes=CLASSES).tiny()
    x = torch.randn(2, LATENT, LATENT, 8, generator=torch.Generator().manual_seed(0))

    def run(remat):
        unet = UNet(dataclasses.replace(cfg, remat=remat), device="cpu",
                    generator=torch.Generator().manual_seed(1))
        tx = tsteps.make_optimizer("adamw", LR)
        state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())))
        step = tsteps.make_ldm_train_step(unet, tddpm.make_schedule(DDPMConfig()), tx,
                                          num_classes=CLASSES)
        gen = torch.Generator().manual_seed(5)
        _, m = step(state, x, generator=gen, labels=torch.tensor([0, 2]))
        return m["loss"], {n: p.grad for n, p in unet.named_parameters()}, gen.get_state()

    plain, remat = run(False), run(True)
    assert torch.equal(plain[0], remat[0]) and torch.equal(plain[2], remat[2])
    assert set(plain[1]) == set(remat[1])
    for n, g in plain[1].items():
        assert torch.equal(g, remat[1][n]), n

    jcfg = dataclasses.replace(JUNetConfig(num_classes=CLASSES, **FIXED).tiny(),
                               stochastic_depth=0.0, remat=True)
    tcfg = dataclasses.replace(UNetConfig(num_classes=CLASSES, **FIXED).tiny(),
                               stochastic_depth=0.0, remat=True)
    xs = np.random.default_rng(4).normal(size=(2, LATENT, LATENT, 8)).astype(np.float32)
    junet, params = _jax_unet(jcfg, xs)
    jsched = jddpm.make_schedule(JDDPMConfig())
    key = jax.random.PRNGKey(3)
    cond = np.array([1, CLASSES], np.int32)

    def jloss(p):
        def denoise(xt, t, kk):
            return junet.apply(p, xt, t, jnp.asarray(cond), deterministic=False,
                               rngs={"moe": kk, "sd": kk}).astype(jnp.float32)
        return jddpm.ddpm_loss(denoise, jsched, jnp.asarray(xs), key)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tunet = unet_from_flax(np_tree(params), tcfg, device="cpu")
    t, eps = _jax_draws(key, 2, xs.shape)
    loss = tddpm.ddpm_loss(
        lambda xt, tt: tunet(xt, tt, torch.from_numpy(cond), deterministic=False),
        tddpm.make_schedule(DDPMConfig()), torch.from_numpy(xs), t=t, eps=eps)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **TOL)
    ref = flatten_tree(np_tree(ref_grads)["params"])
    for n, p in tunet.named_parameters():
        g = np.zeros_like(ref[n]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, ref[n], err_msg=n, **TOL)


class _Labelled:
    def __init__(self, n):
        self.items = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
        self.labels = [i // 3 for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("with_labels", [True, False])
def test_batch_loader_matches_jax(with_labels):
    """The same batches, in the same order, over three epochs (the
    trailing partial batch dropped), and the same int32 labels, as the
    JAX BatchLoader with the same seed."""
    ds = _Labelled(11)
    j = JBatchLoader(ds, 4, seed=3, with_labels=with_labels, shard_index=0,
                     shard_count=1)
    t = BatchLoader(ds, 4, seed=3, with_labels=with_labels)
    assert len(t) == len(j) == 2
    for _ in range(3):
        got, want = list(t), list(j)
        assert len(got) == len(want) == len(t)
        for a, b in zip(got, want):
            if with_labels:
                assert a[1].dtype == np.int32
                np.testing.assert_array_equal(a[1], b[1])
                a, b = a[0], b[0]
            np.testing.assert_array_equal(a, b)


def test_batch_loader_raises_and_stops_its_thread():
    """An error while making a batch reaches the consumer; a consumer
    that stops early stops the prefetch thread."""
    class Bad(_Labelled):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("item 5")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="item 5"):
        list(BatchLoader(Bad(12), 2))
    before = threading.active_count()
    it = iter(BatchLoader(_Labelled(40), 2, prefetch=1))
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_num_classes_per_directory_in_the_trainer(tmp_path, monkeypatch, capsys):
    """--num-classes -1 over two dataset dirs: a 2-class UNet trained on
    the dirs' labels (the class table gets a gradient); fewer classes
    than dirs is refused."""
    monkeypatch.chdir(tmp_path)
    dirs = _cli_images(tmp_path, dirs=("cats", "dogs"), n=2)
    state = train_ldm.main(dirs + CLI + ["-e", "1", "--num-classes", "-1",
                                         "--cond-drop", "0.0"])
    out = capsys.readouterr().out
    assert "class-conditional: 2 classes (dir-per-class), cond-drop 0.0" in out
    assert state.params.cfg.num_classes == 2 and state.step == 2
    table = state.params.class_embed.embedding
    assert table.shape[0] == 3 and table.grad[:2].abs().max() > 0
    assert table.grad[2].abs().max() == 0  # no null-class row at cond-drop 0
    with pytest.raises(SystemExit, match="--num-classes 1 < 2 dataset dirs"):
        train_ldm.main(dirs + CLI + ["--num-classes", "1"])
