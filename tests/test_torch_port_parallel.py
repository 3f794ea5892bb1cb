"""The port's data parallelism against the JAX package (CPU, fp32): the
launch flags, the loader's stripes, the ZeRO-1 plan, 2-rank gloo train
steps (LDM against JAX's single-device step on the global batch and
against the port's 1-process step; ZeRO-1 against plain DP, bitwise;
VAE and pixel DDPM against 1 process) and a 2-process train_ldm run.

The ranks are spawned processes that rendezvous through a FileStore
under the test's tmp_path; they import nothing of JAX (the worker
functions below use torch and the port only)."""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ldm_image_generator_tpu_torch.config import DDPMConfig, DiscriminatorConfig, UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.parallel import mesh as tmesh
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=5e-4, atol=5e-5)
WORLD = 2
GLOBAL_B = 4
LR = 1e-3
# ZeRO-1 runs: the JAX test's min_size, so the tiny UNet splits many leaves
ZERO1_MIN = 1024
VAE_CFG = VAEConfig().tiny()
DISC_CFG = DiscriminatorConfig(channels=(8, 8), stages=(1, 1))
VAE_SIZE, VAE_CROP = 32, 16


def _jax_cfg():
    from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig

    return dataclasses.replace(JUNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                               stochastic_depth=0.0)


PINNED = dataclasses.replace(UNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                             stochastic_depth=0.0)
DRAWN = dataclasses.replace(UNetConfig().tiny(), num_classes=3)
PIXEL = UNetConfig(input_channels=3).tiny()


# --- the ranks' side (torch and the port only) ---------------------------

def _unet(cfg, start):
    unet = UNet(cfg, device="cpu")
    unet.load_state_dict(start)
    return unet


def _ldm_run(cfg, start, xs, optimizer="adamw", dp=None, zero1_min=None, ema=None,
             labels=None, seed=None, inject=None, **opt):
    """(losses, state, tx, gradients per step) of len(xs) LDM train steps
    from `start`: each x the global batch (a rank keeps its rows); draws
    from a generator of `seed`, or t and eps from `inject` [(t, eps) per
    step]."""
    unet = _unet(cfg, start)
    zero1 = None
    if zero1_min is not None:
        zero1 = tmesh.Zero1(list(unet.parameters()), dp, min_size=zero1_min)
    tx = tsteps.make_optimizer(optimizer, LR, zero1=zero1, **opt)
    state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                                 ema_params=tsteps.init_ema(unet) if ema else None)
    step = tsteps.make_ldm_train_step(unet, make_schedule(DDPMConfig()), tx,
                                      ema_decay=ema, num_classes=cfg.num_classes,
                                      reduce_grads=dp)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    rows = slice(None) if dp is None else dp.rows(GLOBAL_B)
    losses, grads = [], []
    for i, x in enumerate(xs):
        kw = {} if inject is None else dict(t=inject[i][0], eps=inject[i][1])
        if labels is not None:
            kw["labels"] = labels[rows]
        state, m = step(state, x[rows], generator=gen, **kw)
        losses.append(m["loss"].item())
        grads.append(_grads(unet))
    return losses, state, tx, grads


def _vae_run(start, xs, seed, dp=None):
    from torch import nn

    from ldm_image_generator_tpu_torch.models.vae import Decoder, Discriminator, Encoder, VectorQuantizer

    vae = nn.ModuleDict({"encoder": Encoder(VAE_CFG, device="cpu"),
                         "decoder": Decoder(VAE_CFG, device="cpu"),
                         "quantizer": VectorQuantizer(VAE_CFG.num_embeddings,
                                                      VAE_CFG.embedding_dim, device="cpu")})
    disc = Discriminator(DISC_CFG, device="cpu")
    vae.load_state_dict(start["vae"])
    disc.load_state_dict(start["disc"])
    tx_v, tx_d = tsteps.make_optimizer("adafactor"), tsteps.make_optimizer("adafactor")
    state = tsteps.VAETrainState(vae_params=vae, disc_params=disc,
                                 opt_state_vae=tx_v.init(list(vae.parameters())),
                                 opt_state_disc=tx_d.init(list(disc.parameters())))
    step = tsteps.make_vae_train_step(vae["encoder"], vae["decoder"], vae["quantizer"],
                                      disc, tx_v, tx_d, crop_size=VAE_CROP,
                                      reduce_grads=dp)
    gen = torch.Generator().manual_seed(seed)
    rows = slice(None) if dp is None else dp.rows(GLOBAL_B)
    metrics, grads = [], []
    for x in xs:
        state, m, _ = step(state, x[rows], generator=gen)
        metrics.append({k: v.item() for k, v in m.items()})
        grads.append(_grads(vae) | _grads(disc, "disc."))
    return metrics, state, grads


def _params(module, prefix: str = "") -> dict:
    return {prefix + n: p.detach().clone() for n, p in module.named_parameters()}


def _grads(module, prefix: str = "") -> dict:
    return {prefix + n: p.grad.clone() for n, p in module.named_parameters()}


def _worker(rank: int, store_path: str, work: str) -> None:
    """Rank `rank` of WORLD: every scenario of inputs.pt, each rank's
    results to <work>/out-<rank>.pt."""
    from ldm_image_generator_tpu_torch.cli.train_ldm import saver
    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        dp = tmesh.DataParallel("cpu")
        out = {}
        # JAX's draws injected: one step on the pinned tiny UNet
        losses, state, _, grads = _ldm_run(PINNED, inp["jax_start"], [inp["jax_x"]],
                                           ema=0.9, dp=dp, inject=[inp["jax_draws"]])
        out["jax"] = dict(loss=losses[0], params=_params(state.params),
                          ema=state.ema_params, grads=grads[0])
        # every draw from the generator: the conditional UNet, routing and
        # stochastic depth drawn, labels dropped at 0.1
        losses, state, _, grads = _ldm_run(DRAWN, inp["drawn_start"], inp["drawn_x"],
                                           dp=dp, labels=inp["labels"], seed=5)
        out["drawn"] = dict(losses=losses, params=_params(state.params), grads=grads)
        # ZeRO-1 against plain DP, clip and cosine schedule, with and
        # without MultiSteps
        for name, accumulate, n in (("zero1", 1, 3), ("zero1_bm2", 2, 4)):
            opt = dict(grad_clip=0.05, lr_schedule="cosine", warmup_steps=1,
                       total_steps=3, accumulate=accumulate)
            xs = inp["drawn_x"][:1] * n
            plain_l, plain, _, _ = _ldm_run(PINNED, inp["jax_start"], xs, dp=dp, seed=7,
                                            **opt)
            z_l, zs, tx, _ = _ldm_run(PINNED, inp["jax_start"], xs, dp=dp, seed=7,
                                      zero1_min=ZERO1_MIN, **opt)
            inner = zs.opt_state if accumulate == 1 else zs.opt_state.inner_opt_state
            out[name] = dict(plain_losses=plain_l, zero1_losses=z_l,
                             plain=_params(plain.params), zero1=_params(zs.params),
                             mu=[m.clone() for m in inner.mu],
                             plan=tx.zero1.plan if accumulate == 1 else tx.inner.zero1.plan,
                             full_mu=[m.numel() for m in plain.opt_state.mu]
                             if accumulate == 1 else None)
            if name == "zero1":
                ckpt = TrainCheckpointer(os.path.join(work, "ckpt"))
                saver(os.path.join(work, "zero1.msgpack"), ckpt,
                      torch.Generator().manual_seed(0), tx, dp)(zs)
        metrics, state, grads = _vae_run(inp["vae_start"], inp["vae_x"], seed=3, dp=dp)
        out["vae"] = dict(metrics=metrics, grads=grads, params=_params(state.vae_params)
                          | _params(state.disc_params, "disc."))
        losses, state, _, grads = _ldm_run(PIXEL, inp["pixel_start"], inp["pixel_x"],
                                           optimizer="radam", dp=dp, seed=9)
        out["pixel"] = dict(losses=losses, params=_params(state.params), grads=grads)
        torch.save(out, os.path.join(work, f"out-{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- the test side ---------------------------------------------------------

def _state_dict(cfg, seed):
    return UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)).state_dict()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """inputs.pt, the JAX reference of the pinned step, and both ranks'
    results."""
    import jax
    import jax.numpy as jnp

    from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
    from ldm_image_generator_tpu.diffusion import ddpm as jddpm
    from ldm_image_generator_tpu.models import UNet as JUNet
    from ldm_image_generator_tpu.train import steps as jsteps
    from ldm_image_generator_tpu_torch.convert import flatten_tree, unet_from_flax
    from ldm_image_generator_tpu_torch.models.vae import Decoder, Discriminator, Encoder, VectorQuantizer
    from test_torch_port_train import _jax_draws

    work = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    jcfg = _jax_cfg()
    junet = JUNet(jcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    x = rng.normal(size=(GLOBAL_B, 8, 8, 8)).astype(np.float32)
    params = jax.jit(junet.init)({"params": key, "moe": key, "sd": key},
                                 jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32))
    jsched = jddpm.make_schedule(JDDPMConfig())
    jtx = jsteps.make_optimizer("adamw", LR)
    jstate = jsteps.LDMTrainState(params=params, opt_state=jtx.init(params),
                                  step=jnp.zeros((), jnp.int32),
                                  ema_params=jsteps.init_ema(params))
    k = jax.random.fold_in(key, 0)
    jnew, jm = jax.jit(jsteps.make_ldm_train_step(junet, jsched, jtx, ema_decay=0.9))(
        jstate, jnp.asarray(x), k)
    start = unet_from_flax(jax.tree.map(np.asarray, params), PINNED, device="cpu").state_dict()
    t_all, eps_all = _jax_draws(k, GLOBAL_B, x.shape)
    vae = torch.nn.ModuleDict({
        "encoder": Encoder(VAE_CFG, device="cpu", generator=torch.Generator().manual_seed(1)),
        "decoder": Decoder(VAE_CFG, device="cpu", generator=torch.Generator().manual_seed(2)),
        "quantizer": VectorQuantizer(VAE_CFG.num_embeddings, VAE_CFG.embedding_dim,
                                     device="cpu", generator=torch.Generator().manual_seed(3))})
    disc = Discriminator(DISC_CFG, device="cpu", generator=torch.Generator().manual_seed(4))
    f32 = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    inputs = dict(
        jax_start=start, jax_x=torch.from_numpy(x), jax_draws=(t_all, eps_all),
        drawn_start=_state_dict(DRAWN, 1), drawn_x=[f32(GLOBAL_B, 8, 8, 8) for _ in range(2)],
        labels=torch.tensor([0, 2, 1, 2]),
        vae_start=dict(vae=vae.state_dict(), disc=disc.state_dict()),
        vae_x=[f32(GLOBAL_B, VAE_SIZE, VAE_SIZE, 3).clamp(-1, 1)],
        pixel_start=_state_dict(PIXEL, 2), pixel_x=[f32(GLOBAL_B, 8, 8, 3) for _ in range(2)])
    torch.save(inputs, work / "inputs.pt")
    mp.start_processes(_worker, args=(str(work / "store"), str(work)), nprocs=WORLD,
                       start_method="spawn")
    ranks = [torch.load(work / f"out-{r}.pt", weights_only=False) for r in range(WORLD)]
    flat = lambda tree: flatten_tree(jax.tree.map(np.asarray, tree)["params"])
    jax_ref = dict(loss=float(jm["loss"]), params=flat(jnew.params),
                   ema=flat(jnew.ema_params), mu=flat(jnew.opt_state[0].mu))
    return dict(work=work, inputs=inputs, ranks=ranks, jax=jax_ref)


def _close_params(got: dict, module, grads: list, got_grads: list) -> None:
    """got (a rank's parameters) at the fp32 tolerance of module's after
    the same steps, elements whose 1-process gradient in any step
    (`grads`, one {name: tensor} per step) was within GRAD_ZERO of 0 and
    not 0 on both sides (got_grads) exempt (Adam moves them by about lr
    whatever their rounding), at most EXEMPT_SHARE of them."""
    from test_torch_port_train import EXEMPT_SHARE, GRAD_ZERO

    exempt = {n: torch.stack([(g[n].abs() <= GRAD_ZERO) & ~((g[n] == 0) & (h[n] == 0))
                              for g, h in zip(grads, got_grads)]).any(0)
              for n in grads[0]}
    assert sum(int(e.sum()) for e in exempt.values()) <= EXEMPT_SHARE * sum(
        e.numel() for e in exempt.values())
    for n, p in module.named_parameters():
        keep = ~exempt[n]
        np.testing.assert_allclose(got[n][keep].numpy(), p.detach()[keep].numpy(),
                                   err_msg=n, **TOL)


def _same_on_ranks(ranks, scenario, key):
    a, b = ranks[0][scenario][key], ranks[1][scenario][key]
    for n in a:
        assert torch.equal(a[n], b[n]), (scenario, key, n)


def test_dp_step_matches_jax_global_batch(run):
    """2 ranks of 2 rows, JAX's draws of the 4-row batch injected: the
    loss, the all-reduced gradients (against an eager jax.grad), and the
    updated parameters and EMA match JAX's single-device step on the
    global batch. The JAX step's gradient is read back from its Adam
    first moment (0.1 g after one step); parameters and EMA follow the
    exemption rule of test_four_train_steps_match_jax (elements whose JAX
    gradient is rounding are exempt, and few)."""
    from test_torch_port_train import EXEMPT_SHARE, GRAD_ATOL, GRAD_RTOL, GRAD_ZERO

    ranks, ref = run["ranks"], run["jax"]
    for key in ("params", "ema", "grads"):
        _same_on_ranks(ranks, "jax", key)
    got = ranks[0]["jax"]
    np.testing.assert_allclose(got["loss"], ref["loss"], **TOL)
    grads = {n: g.numpy() for n, g in got["grads"].items()}
    assert set(grads) == set(ref["mu"])
    exempt = {}
    for n, m in ref["mu"].items():  # mu = 0.1 g after one step
        g_jax = m.astype(np.float64) / 0.1
        np.testing.assert_allclose(grads[n], g_jax, err_msg=n, **TOL)
        zero = (np.abs(g_jax) <= GRAD_ZERO) & ~((g_jax == 0) & (grads[n] == 0))
        exempt[n] = zero | (np.abs(grads[n] - g_jax) > GRAD_ATOL + GRAD_RTOL * np.abs(g_jax))
    assert sum(int(e.sum()) for e in exempt.values()) <= EXEMPT_SHARE * sum(
        e.size for e in exempt.values())
    for what in ("params", "ema"):
        for n, v in ref[what].items():
            keep = ~exempt[n]
            np.testing.assert_allclose(got[what][n].numpy()[keep], v[keep],
                                       err_msg=f"{what} {n}", **TOL)


def _close_grads(got: list, want: list) -> None:
    for g, w in zip(got, want):
        for n in w:
            np.testing.assert_allclose(g[n].numpy(), w[n].numpy(), err_msg=n, **TOL)


def test_dp_step_matches_one_process(run):
    """The same injected step in one process on the 4-row batch, and the
    conditional UNet with every draw (drop, t, noise, routing, gates)
    from one seed over 2 steps: the ranks stay bitwise equal, and the
    losses, all-reduced gradients and parameters match the 1-process
    steps (fp32 tolerance; the sums split over ranks)."""
    ranks, inp = run["ranks"], run["inputs"]
    losses, state, _, grads = _ldm_run(PINNED, inp["jax_start"], [inp["jax_x"]],
                                       ema=0.9, inject=[inp["jax_draws"]])
    np.testing.assert_allclose(ranks[0]["jax"]["loss"], losses[0], rtol=1e-6)
    _close_grads([ranks[0]["jax"]["grads"]], grads)
    _close_params(ranks[0]["jax"]["params"], state.params, grads, [ranks[0]["jax"]["grads"]])
    _same_on_ranks(ranks, "drawn", "params")
    assert ranks[0]["drawn"]["losses"] == ranks[1]["drawn"]["losses"]
    losses, state, _, grads = _ldm_run(DRAWN, inp["drawn_start"], inp["drawn_x"],
                                       labels=inp["labels"], seed=5)
    np.testing.assert_allclose(ranks[0]["drawn"]["losses"], losses, rtol=1e-5)
    _close_grads(ranks[0]["drawn"]["grads"], grads)
    _close_params(ranks[0]["drawn"]["params"], state.params, grads,
                  ranks[0]["drawn"]["grads"])


@pytest.mark.parametrize("scenario", ["zero1", "zero1_bm2"])
def test_zero1_is_plain_dp_bitwise(run, scenario):
    """--zero1 with --grad-clip (active: 0.05) and a cosine schedule, over
    3 steps and over 4 steps of -bm 2: parameters and losses bitwise those
    of plain DP on every rank; each rank holds only its slices of the
    split moments."""
    for r in run["ranks"]:
        res = r[scenario]
        assert res["plain_losses"] == res["zero1_losses"]
        for n, p in res["plain"].items():
            assert torch.equal(res["zero1"][n], p), n
    _same_on_ranks(run["ranks"], scenario, "zero1")
    res = run["ranks"][0][scenario]
    split = [i for i, d in enumerate(res["plan"]) if d is not None]
    assert split and len(split) < len(res["plan"])
    if res["full_mu"] is not None:
        for i in split:
            assert res["mu"][i].numel() * WORLD == res["full_mu"][i]


def test_zero1_state_file_resumes_at_world_size_one(run):
    """The state file rank 0 wrote holds the moments whole: restored into
    a 1-process state it gives each rank's slices and parameters bitwise,
    and the run goes on from it."""
    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer

    work, inp = run["work"], run["inputs"]
    opt = dict(grad_clip=0.05, lr_schedule="cosine", warmup_steps=1, total_steps=3)
    unet = _unet(PINNED, inp["jax_start"])
    tx = tsteps.make_optimizer("adamw", LR, **opt)
    state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())))
    state = TrainCheckpointer(str(work / "ckpt")).restore(state, [torch.Generator()])
    assert state.step == 3 and state.opt_state.count == 3
    zero1 = tmesh.Zero1(list(unet.parameters()), _FakeDP(0), min_size=ZERO1_MIN)
    for r, res in enumerate(run["ranks"]):
        zero1.dp.rank = r
        for i, mu in enumerate(res["zero1"]["mu"]):
            assert torch.equal(zero1.local(state.opt_state.mu[i], i), mu), i
    for n, p in unet.named_parameters():
        assert torch.equal(p, run["ranks"][0]["zero1"]["zero1"][n]), n
    step = tsteps.make_ldm_train_step(unet, make_schedule(DDPMConfig()), tx)
    state, m = step(state, inp["drawn_x"][0], generator=torch.Generator().manual_seed(1))
    assert state.step == 4 and np.isfinite(m["loss"].item())


class _FakeDP:
    """The rank and world a Zero1 plan reads, without a group."""

    def __init__(self, rank):
        self.rank, self.world = rank, WORLD


def test_vae_dp_step_matches_one_process(run):
    """A 2-rank VAE + discriminator step (Adafactor, crop offset and noise
    drawn from one seed): ranks bitwise equal, metrics, gradients and
    parameters as one process's step on the global batch."""
    ranks, inp = run["ranks"], run["inputs"]
    _same_on_ranks(ranks, "vae", "params")
    metrics, state, grads = _vae_run(inp["vae_start"], inp["vae_x"], seed=3)
    for k, v in metrics[0].items():
        np.testing.assert_allclose(ranks[0]["vae"]["metrics"][0][k], v, rtol=1e-5, err_msg=k)
    _close_grads(ranks[0]["vae"]["grads"], grads)
    both = torch.nn.ModuleDict(dict(state.vae_params.items(), disc=state.disc_params))
    _close_params(ranks[0]["vae"]["params"], both, grads, ranks[0]["vae"]["grads"])


def test_pixel_ddpm_radam_dp_matches_one_process(run):
    ranks, inp = run["ranks"], run["inputs"]
    _same_on_ranks(ranks, "pixel", "params")
    losses, state, _, grads = _ldm_run(PIXEL, inp["pixel_start"], inp["pixel_x"],
                                       optimizer="radam", seed=9)
    np.testing.assert_allclose(ranks[0]["pixel"]["losses"], losses, rtol=1e-5)
    _close_grads(ranks[0]["pixel"]["grads"], grads)
    _close_params(ranks[0]["pixel"]["params"], state.params, grads,
                  ranks[0]["pixel"]["grads"])


def test_zero1_plan_matches_jax_shardings():
    """zero1_dim on every parameter of the tiny UNet (at the default and
    at a small min_size) gives the dimension zero1_shardings(tree,
    make_mesh(2)) puts 'data' on for its AdamW moments (None where
    replicated)."""
    import jax
    import jax.numpy as jnp

    from ldm_image_generator_tpu.models import UNet as JUNet
    from ldm_image_generator_tpu.parallel.mesh import make_mesh, zero1_shardings
    from ldm_image_generator_tpu.train import steps as jsteps

    junet = JUNet(_jax_cfg(), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(junet.init, {"params": key, "moe": key, "sd": key},
                            jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,), jnp.int32))
    opt = jax.eval_shape(jsteps.make_optimizer("adamw", LR).init, params)
    unet = UNet(PINNED, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    for min_size in (tmesh.ZERO1_MIN_SIZE, ZERO1_MIN):
        specs = zero1_shardings(opt, make_mesh(2), min_size=min_size)
        mu = {".".join(k.key for k in path[1:]): tuple(sharding.spec)
              for path, sharding in jax.tree_util.tree_leaves_with_path(specs[0].mu)}
        assert set(mu) == set(shapes)
        for n, spec in mu.items():
            want = spec.index("data") if "data" in spec else None
            assert tmesh.zero1_dim(shapes[n], 2, min_size) == want, (n, spec)
        assert any(tmesh.zero1_dim(s, 2, min_size) is not None for s in shapes.values())


class _Items:
    """An in-memory dataset both packages' loaders read."""

    def __init__(self, n):
        self.items = np.arange(n * 6, dtype=np.float32).reshape(n, 1, 2, 3)
        self.labels = [i % 3 for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("n,batch,count", [(10, 4, 2), (12, 6, 3), (9, 4, 1)])
def test_batch_loader_stripes_match_jax(n, batch, count):
    """Each shard's batches and labels are the JAX loader's for the same
    seed, shard index and count, and the stripes reassemble the whole
    batch (tests/test_data.py test_batch_loader_multihost_sharding)."""
    from ldm_image_generator_tpu.data.loader import BatchLoader as JBatchLoader
    from ldm_image_generator_tpu_torch.data.loader import BatchLoader

    ds = _Items(n)
    whole = list(BatchLoader(ds, batch, seed=3, with_labels=True))
    shards = []
    for i in range(count):
        got = list(BatchLoader(ds, batch, seed=3, with_labels=True, shard_index=i,
                               shard_count=count))
        want = list(JBatchLoader(ds, batch, seed=3, with_labels=True, shard_index=i,
                                 shard_count=count, prefetch=1))
        assert len(got) == len(want) == len(whole)
        for (g, gl), (w, wl) in zip(got, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(gl, wl)
        shards.append(got)
    for b, (w, wl) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([s[b][0] for s in shards]), w)
        np.testing.assert_array_equal(np.concatenate([s[b][1] for s in shards]), wl)


def test_batch_loader_defaults_to_the_group_and_checks_the_split():
    from ldm_image_generator_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(_Items(8), 4)
    assert (loader.shard_index, loader.shard_count) == (0, 1)
    with pytest.raises(ValueError, match="does not split"):
        BatchLoader(_Items(8), 3, shard_index=0, shard_count=2)


LAUNCH_CASES = [
    (dict(), {}, None),
    (dict(coordinator="h:1"), {}, "needs all three"),
    (dict(process_id=0, num_processes_dist=2), {}, "needs all three"),
    (dict(coordinator="h:1", num_processes_dist=2), {}, "needs all three"),
    (dict(coordinator="h:1", process_id=0, num_processes_dist=1), {}, None),
    (dict(), dict(LDM_COORDINATOR="h:1", LDM_PROCESS_ID="0"), "needs all three"),
    (dict(), dict(LDM_COORDINATOR="h:1", LDM_PROCESS_ID="0", LDM_NUM_PROCESSES="1"),
     None),
    (dict(process_id=0), dict(LDM_COORDINATOR="h:1", LDM_NUM_PROCESSES="1"), None),
    (dict(coordinator="h:1", process_id=0, num_processes_dist=0), {}, "needs all three"),
]


@pytest.mark.parametrize("flags,env,error", LAUNCH_CASES)
def test_launch_parsing_matches_jax(monkeypatch, flags, env, error):
    """maybe_init_distributed reads the flags and the LDM_* env vars as
    JAX's does: the same SystemExit message, and no group for 1 process
    or none given."""
    import argparse

    from ldm_image_generator_tpu.cli import common as jcommon
    from ldm_image_generator_tpu_torch.cli import common

    for k in ("LDM_COORDINATOR", "LDM_PROCESS_ID", "LDM_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = argparse.Namespace(coordinator=None, process_id=None, num_processes_dist=None)
    vars(args).update(flags)
    if error is None:
        assert jcommon.maybe_init_distributed(args) is False
        assert common.maybe_init_distributed(args, "cpu") is False
        assert not dist.is_initialized()
        return
    with pytest.raises(SystemExit) as jexc:
        jcommon.maybe_init_distributed(args)
    with pytest.raises(SystemExit) as exc:
        common.maybe_init_distributed(args, "cpu")
    assert str(exc.value) == str(jexc.value) and error in str(exc.value)


def test_launch_args_match_jax():
    import argparse

    from ldm_image_generator_tpu.cli.common import add_device_arg
    from ldm_image_generator_tpu_torch.cli.common import add_launch_args

    jp, p = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_device_arg(jp)
    add_launch_args(p)
    flags = ["--coordinator", "a:5", "--process-id", "1", "--num-processes", "3"]
    j, t = jp.parse_args(flags), p.parse_args(flags)
    for k in ("coordinator", "process_id", "num_processes_dist"):
        assert getattr(j, k) == getattr(t, k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_train_ldm_cli(tmp_path):
    """Two `cli.train_ldm -d cpu --config tiny` processes of one group:
    both exit 0 over gloo, each loads 1 row of the global batch of 2, and
    only rank 0 writes the parameter file."""
    from test_torch_port_train import _images

    imgs = _images(tmp_path)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ldm_image_generator_tpu_torch.cli.train_ldm", imgs,
         "-d", "cpu", "--config", "tiny", "-s", "32", "-b", "2", "-e", "1",
         "--zero1", "--coordinator", f"127.0.0.1:{port}", "--process-id", str(r),
         "--num-processes", "2", "-mp", str(tmp_path / "ddpm.pt")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"distributed: process {r}/2 via 127.0.0.1:{port}, backend gloo" in out
        assert "data-parallel over 2 processes" in out
        assert "ZeRO-1: optimizer state split" in out
    assert "saved " in outs[0] and "saved " not in outs[1]
    assert (tmp_path / "ddpm.pt").stat().st_size > 0
