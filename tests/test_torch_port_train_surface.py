"""The port's training run surface against the JAX package (CPU): the
NaN/Inf guards, the SIGTERM hook and the metric logger; the training
checkpointer (keep 3, atomic steps, orbax directories refused); resume
bitwise (N + M steps against N, save, restore into fresh modules, M);
the trainers' periodic saves, SIGTERM saves and the non-finite check."""
import dataclasses
import io
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import DiscriminatorConfig as JDiscConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.models import vae as jvae
from ldm_image_generator_tpu.utils import debug as jdebug
from ldm_image_generator_tpu.utils import metrics as jmetrics
from ldm_image_generator_tpu.utils.checkpoint import load_params as jload_params
from ldm_image_generator_tpu_torch.cli import train_ldm, train_vae
from ldm_image_generator_tpu_torch.config import (
    DDPMConfig,
    DiscriminatorConfig,
    UNetConfig,
    VAEConfig,
)
from ldm_image_generator_tpu_torch.convert import flatten_tree
from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import (
    Decoder,
    Discriminator,
    Encoder,
    VectorQuantizer,
)
from ldm_image_generator_tpu_torch.train import steps as tsteps
from ldm_image_generator_tpu_torch.utils import checkpoint as tckpt
from ldm_image_generator_tpu_torch.utils import debug as tdebug
from ldm_image_generator_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DISC = dict(channels=(8, 8), stages=(1, 1))


# -- guards, the SIGTERM hook, the logger ----------------------------------


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"), -float("inf")])
def test_finite_flag_matches_jax(bad):
    """finite_flag over a tensor, a nested dict and list, and a module's
    parameters, against JAX's finite_flag on the same arrays; integer
    leaves are ignored."""
    rng = np.random.default_rng(0)
    arrs = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  np.arange(4, dtype=np.int32)]}
    if bad is not None:
        arrs["b"][0][2] = bad
    want = bool(jdebug.finite_flag(jax.tree.map(jnp.asarray, arrs)))
    tree = {"a": torch.from_numpy(arrs["a"]),
            "b": [torch.from_numpy(arrs["b"][0]), torch.from_numpy(arrs["b"][1])]}
    got = tdebug.finite_flag(tree)
    assert got.dtype == torch.bool and got.ndim == 0
    assert bool(got) == want == (bad is None)
    assert bool(tdebug.finite_flag(tree["b"][0])) == want
    lin = torch.nn.Linear(3, 2)
    assert bool(tdebug.finite_flag(lin))
    with torch.no_grad():
        lin.weight[0, 0] = float("nan")
    assert not bool(tdebug.finite_flag(lin))
    assert bool(tdebug.finite_flag({})) and bool(jdebug.finite_flag({}))


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf"), 1.5])
def test_assert_finite_metrics_matches_jax(value):
    """The same error text as the JAX package's, from tensor metrics; a
    value that is not a number is passed over."""
    def run(mod, metrics):
        try:
            mod.assert_finite_metrics(metrics, 50)
        except Exception as e:  # noqa: BLE001 - the two packages' own classes
            return type(e).__name__, str(e)
        return None

    want = run(jdebug, {"loss": jnp.float32(0.5), "d_loss": jnp.float32(value),
                        "name": "run"})
    got = run(tdebug, {"loss": torch.tensor(0.5), "d_loss": torch.tensor(value),
                       "name": "run"})
    assert got == want
    if value == 1.5:
        assert got is None
    else:
        assert got[0] == "NonFiniteError" and "at step 50" in got[1]
        assert issubclass(tdebug.NonFiniteError, RuntimeError)


def test_graceful_shutdown_sets_its_flag_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    shutdown = tdebug.GracefulShutdown()
    try:
        assert not shutdown.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if shutdown.requested:
                break
            time.sleep(0.01)
        assert shutdown.requested
    finally:
        shutdown.restore()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_metric_logger_records_match_jax(monkeypatch):
    """The same JSONL text as the JAX MetricLogger for one sequence of
    calls (steps that jump by a fused group, extras, log_now, a value
    that is not a number), under one fake clock."""
    def lines(mod, scalar):
        clock = iter(np.arange(1, 100) * 0.37)
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        out = io.StringIO()
        logger = mod.MetricLogger(log_every=10, stream=out)
        for step, loss in ((3, 0.5), (10, 0.25), (12, 1 / 3), (25, 2 / 7), (34, 0.1)):
            logger.log(step, {"loss": scalar(loss), "loss_gmax": scalar(loss * 2),
                              "tag": "x"}, batch_size=8, epoch=1)
        logger.log_now(34, {"val_loss": scalar(0.123456789)})
        logger.log(44, {"loss": scalar(0.7)})
        return out.getvalue()

    want = lines(jmetrics, lambda v: jnp.float32(v))
    got = lines(tmetrics, lambda v: torch.tensor(v, dtype=torch.float32))
    assert got == want
    assert len(got.splitlines()) == 4 and '"images_per_s"' in got


# -- the checkpointer --------------------------------------------------------


def _small_state(seed: int):
    gen = torch.Generator().manual_seed(seed)
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    tx = tsteps.make_optimizer("adamw", 1e-3, accumulate=2)
    return tsteps.LDMTrainState(params=lin, opt_state=tx.init(list(lin.parameters())),
                                ema_params=tsteps.init_ema(lin)), gen


def test_checkpointer_keeps_three_and_restores_the_latest(tmp_path):
    ck = tckpt.TrainCheckpointer(str(tmp_path / "ck"))
    state, gen = _small_state(0)
    assert ck.latest_step() is None and ck.restore(state, [gen]) is None
    weights = {}
    for step in range(1, 6):
        with torch.no_grad():
            state.params.weight.add_(1.0)
        weights[step] = state.params.weight.detach().clone()
        state = dataclasses.replace(state, step=step)
        ck.save(step, state, [gen])
    ck.save(5, state, [gen])  # the same step again replaces it
    assert ck.steps() == [3, 4, 5] and ck.latest_step() == 5
    assert sorted(os.listdir(ck.directory)) == ["3", "4", "5"]
    fresh, fresh_gen = _small_state(1)
    restored = ck.restore(fresh, [fresh_gen])
    assert restored.step == 5 and restored.params is fresh.params
    assert torch.equal(fresh.params.weight, state.params.weight)
    assert torch.equal(fresh_gen.get_state(), gen.get_state())
    old = ck.restore(_small_state(2)[0], [torch.Generator()], step=3)
    assert torch.equal(old.params.weight, weights[3])
    with pytest.raises(ValueError, match="generator states"):
        ck.restore(_small_state(2)[0], [])


def test_checkpointer_write_is_atomic(tmp_path, monkeypatch):
    """A save that dies while writing leaves no step directory and no
    temporary one, and the latest step stays the last whole one."""
    ck = tckpt.TrainCheckpointer(str(tmp_path / "ck"))
    state, gen = _small_state(0)
    ck.save(1, state, [gen])

    def dies(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError, match="disk full"):
        ck.save(2, state, [gen])
    assert os.listdir(ck.directory) == ["1"] and ck.latest_step() == 1
    monkeypatch.undo()
    assert ck.restore(_small_state(1)[0], [torch.Generator()]).step == 0


def test_checkpointer_refuses_an_orbax_directory(tmp_path):
    """A directory the JAX package's TrainCheckpointer (orbax) wrote is
    refused, and so is by the trainer's --ckpt-dir; a structure that does
    not match the state raises."""
    from ldm_image_generator_tpu.utils.checkpoint import TrainCheckpointer as JCkpt

    jck = JCkpt(str(tmp_path / "orbax"))
    jck.save(3, {"w": jnp.ones((2,))}, wait=True)
    jck.close()
    with pytest.raises(ValueError, match="resumes only from its own checkpoints"):
        tckpt.TrainCheckpointer(str(tmp_path / "orbax"))
    with pytest.raises(SystemExit, match="resumes only from its own checkpoints"):
        train_vae.main([_images(tmp_path), *TRAINERS["vae"][1],
                        "--ckpt-dir", str(tmp_path / "orbax")])
    ck = tckpt.TrainCheckpointer(str(tmp_path / "ck"))
    state, gen = _small_state(0)
    ck.save(1, state, [gen])
    other = tsteps.LDMTrainState(params=torch.nn.Linear(4, 2), opt_state=None)
    with pytest.raises(ValueError):
        ck.restore(other, [gen])


# -- resume, bitwise -----------------------------------------------------------


def _ldm_run(seed: int):
    """(state, step, generator) of a tiny UNet with random routing and
    stochastic depth, AdamW inside MultiSteps(2) and an EMA; parameters
    from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    unet = UNet(UNetConfig().tiny(), device="cpu", generator=gen)
    tx = tsteps.make_optimizer("adamw", 1e-3, accumulate=2)
    state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                                 ema_params=tsteps.init_ema(unet))
    step = tsteps.make_ldm_train_step(unet, make_schedule(DDPMConfig()), tx,
                                      ema_decay=0.9)
    return state, (lambda s, x: step(s, x, generator=gen)), gen


def _vae_run(seed: int):
    gen = torch.Generator().manual_seed(seed)
    cfg = VAEConfig().tiny()
    vae = torch.nn.ModuleDict({
        "encoder": Encoder(cfg, device="cpu", generator=gen),
        "decoder": Decoder(cfg, device="cpu", generator=gen),
        "quantizer": VectorQuantizer(cfg.num_embeddings, cfg.embedding_dim,
                                     device="cpu", generator=gen)})
    disc = Discriminator(DiscriminatorConfig(**TINY_DISC), device="cpu", generator=gen)
    tx_v, tx_d = tsteps.make_optimizer("adafactor"), tsteps.make_optimizer("adafactor")
    state = tsteps.VAETrainState(vae_params=vae, disc_params=disc,
                                 opt_state_vae=tx_v.init(list(vae.parameters())),
                                 opt_state_disc=tx_d.init(list(disc.parameters())))
    step = tsteps.make_vae_train_step(vae["encoder"], vae["decoder"], vae["quantizer"],
                                      disc, tx_v, tx_d, crop_size=16)
    return state, (lambda s, x: step(s, x, generator=gen)[:2]), gen


def _leaves(tree, prefix="state"):
    """{path: tensor or int} over a state_tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("what", ["ldm", "vae"])
def test_resume_is_bitwise(tmp_path, what):
    """N steps, save, restore into freshly built modules (other seeded
    weights) with the generator's saved state, M more steps on the same
    batches: bitwise the state of N + M steps in one run. LDM: N = 3 with
    -bm 2, so the restored MultiSteps window is half full, plus the EMA;
    VAE: both Adafactor states."""
    make, shape, n, m = ((_ldm_run, (2, 8, 8, 8), 3, 2) if what == "ldm"
                         else (_vae_run, (2, 32, 32, 3), 2, 2))
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.uniform(-1, 1, size=shape).astype(np.float32))
               for _ in range(n + m)]
    state, step, gen = make(0)
    for x in batches:
        state, metrics = step(state, x)
    want = tckpt.state_tree(state)

    state, step, gen = make(0)
    for x in batches[:n]:
        state, _ = step(state, x)
    if what == "ldm":
        assert state.opt_state.mini_step == 1
        assert any(a.abs().max() > 0 for a in state.opt_state.acc_grads)
    tckpt.TrainCheckpointer(str(tmp_path)).save(state.step, state, [gen])
    fresh, step, gen = make(1)
    fresh = tckpt.TrainCheckpointer(str(tmp_path)).restore(fresh, [gen])
    assert fresh.step == n
    saved = tckpt.state_tree(state)
    for k, v in _leaves(tckpt.state_tree(fresh)).items():
        w = _leaves(saved)[k]
        assert (torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w), k
    for x in batches[n:]:
        fresh, _ = step(fresh, x)
    got = _leaves(tckpt.state_tree(fresh))
    ref = _leaves(want)
    assert set(got) == set(ref)
    for k, v in got.items():
        assert (torch.equal(v, ref[k]) if isinstance(v, torch.Tensor)
                else v == ref[k]), k


# -- the trainers --------------------------------------------------------------


def _images(tmp_path, n=4, name="imgs"):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / name
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            d / f"{i}.png")
    return str(d)


TRAINERS = {
    "ldm": (train_ldm, ["--config", "tiny", "-s", "32", "-b", "2", "-d", "cpu",
                        "--ema", "0.999"]),
    "vae": (train_vae, ["--config", "tiny", "-s", "32", "-b", "2", "-d", "cpu",
                        "-r", "out"]),
}


@pytest.mark.parametrize("what", ["ldm", "vae"])
def test_cli_resumes_from_its_checkpoint(tmp_path, capsys, monkeypatch, what):
    mod, flags = TRAINERS[what]
    monkeypatch.chdir(tmp_path)
    imgs = _images(tmp_path)
    first = mod.main([imgs, *flags, "-e", "1", "--ckpt-dir", "ck"])
    out = capsys.readouterr().out
    assert "Resumed" not in out and first.step == 2
    # saved after the first batch (the save cadence) and at the end
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "2"]
    second = mod.main([imgs, *flags, "-e", "1", "--ckpt-dir", "ck"])
    out = capsys.readouterr().out
    assert "Resumed from step 2" in out and second.step == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3", "4"]


def _jax_vae_targets():
    """{file flag: JAX param tree} of the tiny VAE parts and discriminator,
    for the JAX package's load_params."""
    cfg = JVAEConfig().tiny()
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1, 16, 16, cfg.latent_channels))
    img0 = jnp.zeros((1, 32, 32, 3))
    inits = {
        "vae_encoder.pt": lambda: jvae.Encoder(cfg).init(key, img0),
        "vae_decoder.pt": lambda: jvae.Decoder(cfg).init(key, z0),
        "vae_quantizer.pt": lambda: jvae.VectorQuantizer(
            cfg.num_embeddings, cfg.embedding_dim).init(
                key, z0.reshape(1, -1, cfg.latent_channels)),
        "discriminator.pt": lambda: jvae.Discriminator(JDiscConfig(**TINY_DISC)).init(
            key, img0),
    }
    return {name: jax.eval_shape(init) for name, init in inits.items()}


def test_vae_save_every_writes_the_four_files(tmp_path, monkeypatch):
    """--save-every 2 over 3 steps saves after batches 0 and 2 and at the
    end, each time the four parameter files: read back (by the port and
    by the JAX package's load_params) equal to the modules at that moment."""
    from ldm_image_generator_tpu_torch import convert

    monkeypatch.chdir(tmp_path)
    imgs = _images(tmp_path, n=6)
    targets = _jax_vae_targets()
    real_save = convert.save_flax_file
    saves = []

    def checked_save(module, path):
        real_save(module, path)
        live = {n: p.detach().clone() for n, p in module.named_parameters()}
        back = tckpt.load_params(path)["params"]
        jax_back = jload_params(path, targets[os.path.basename(path)])["params"]
        for tree in (back, jax_back):
            flat = flatten_tree(jax.tree.map(np.asarray, tree))
            assert set(flat) == set(live)
            for n, v in live.items():
                np.testing.assert_array_equal(np.asarray(flat[n]), v.numpy(), err_msg=n)
        saves.append(os.path.basename(path))

    monkeypatch.setattr(convert, "save_flax_file", checked_save)
    state = train_vae.main([imgs, *TRAINERS["vae"][1], "-e", "1", "--save-every", "2"])
    assert state.step == 3
    assert saves == list(targets) * 3
    for i in (0, 2):
        for name in ("reconstructed", "input"):
            assert (tmp_path / "out" / f"{i}_{name}.jpg").stat().st_size > 0


@pytest.mark.parametrize("what", ["ldm", "vae"])
def test_sigterm_saves_and_exits_cleanly(tmp_path, what):
    """SIGTERM to a running trainer: it finishes the step, says so, saves
    its parameter files and a checkpoint, and exits with 0."""
    mod, flags = TRAINERS[what]
    imgs = _images(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONIOENCODING="utf-8",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", mod.__name__, imgs, *flags, "-e", "100000",
         "--ckpt-dir", "ck"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("Epoch #1"):
                proc.send_signal(signal.SIGTERM)
                break
        out = "".join(seen) + proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "SIGTERM received — saving and exiting" in out
    assert "interrupted — saving" in out
    names = (["ddpm.pt", "ddpm.pt.ema"] if what == "ldm" else
             ["vae_encoder.pt", "vae_decoder.pt", "vae_quantizer.pt", "discriminator.pt"])
    for name in names:
        assert (tmp_path / name).stat().st_size > 0
    steps = tckpt.TrainCheckpointer(str(tmp_path / "ck")).steps()
    assert steps and steps[-1] >= 2


@dataclasses.dataclass
class _Stub:
    step: int = 0


@pytest.mark.parametrize("fused,nan_steps,message", [
    (1, range(40, 100), "non-finite metric loss=nan at step 50"),
    (4, [49], "non-finite metric loss_gmax=nan at step 52"),
])
def test_run_loop_raises_non_finite_at_the_check(fused, nan_steps, message):
    """A loss that turns NaN reaches NonFiniteError at the step count's
    crossing of 50 (with --fused-steps, through the group max when the
    group's last step is finite); the run stops there and still saves."""
    def step(state, item):
        s = state.step + 1
        return _Stub(s), {"loss": torch.tensor(float("nan") if s in nan_steps else 0.5)}

    saved = []
    with pytest.raises(tdebug.NonFiniteError, match=message):
        train_ldm.train_loop(_Stub(), step, list(range(80)), epochs=1, batch_size=2,
                             save_all=lambda s: saved.append(s.step),
                             fused_steps=fused, logger=tmetrics.MetricLogger(
                                 stream=io.StringIO()))
    assert saved == [fused, int(message.split()[-1])]
