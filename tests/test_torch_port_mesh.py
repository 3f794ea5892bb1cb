"""The port's mesh layouts against the JAX package (CPU, fp32): the mesh
coordinates and batch stripes against make_mesh / make_multislice_mesh /
batch_sharding / spatial_sharding, the tensor- and expert-parallel
parameter plans against param_shardings, the train step of every layout
(dp 2 x tp 2, dp 2 x ep 2, dp 1 x sp 4 on a 16x16 map, multi-slice
2 x 1 x 2, dp 2 x tp 2 with ZeRO-1) against JAX's single-device step on
the global batch at tests/test_parallel.py's tolerances, TP and EP at
data 1 bitwise the port's one-process step, the spatial split's halo conv
and gathered window attention against the whole-map modules, Adafactor
on split parameters against Adafactor on whole ones, and the refusal of
an odd stripe.

The ranks are 4 spawned processes that rendezvous through a FileStore
under the test's tmp_path and run every scenario in one group; they
import nothing of JAX (the worker functions below use torch and the port
only)."""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig
from ldm_image_generator_tpu_torch.data.loader import BatchLoader
from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.parallel import mesh as tmesh
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

WORLD = 4
LR = 1e-3
# tests/test_parallel.py's tiny UNet: its 256-channel stage engages TP
CFG = UNetConfig(input_channels=4, stages=(1, 1), channels=(32, 256),
                 stochastic_depth=0.0, fixed_expert_indices=(0, 1))
# routing and stochastic depth drawn (the bitwise checks against one
# process, where an expert's owner varies with the draw)
DRAWN = dataclasses.replace(CFG, fixed_expert_indices=None, stochastic_depth=0.25)
B, HW = 8, 8            # the global batch of the dp layouts, 8x8 maps
SP_B, SP_HW = 4, 16     # the spatial layout's (JAX's test: 16x16, H over 4)
ZERO1_MIN = 1024
# JAX's own tolerances (tests/test_parallel.py): loss, parameters
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


# --- the ranks' side (torch and the port only) ---------------------------

def _layout(name, mesh_args, expert=False, zero1=False, spatial=False):
    return dict(name=name, mesh=mesh_args, expert=expert, zero1=zero1, spatial=spatial)


LAYOUTS = [
    _layout("dp2_tp2", ("mesh", 2)),
    _layout("dp2_ep2", ("mesh", 2), expert=True),
    _layout("sp4", ("mesh", 4), spatial=True),
    _layout("ms2x1x2", ("multislice", 2, 2)),
    _layout("dp2_tp2_zero1", ("mesh", 2), zero1=True),
]
MESHES = {"mesh2": ("mesh", 2), "mesh4": ("mesh", 4), "ms2x2x1": ("multislice", 2, 1),
          "ms2x1x2": ("multislice", 2, 2), "first2": ("first", 2)}


def _make_mesh(args):
    if args[0] == "mesh":
        return tmesh.make_mesh(WORLD, model_parallel=args[1])
    if args[0] == "first":  # a model-parallel mesh over the first n processes
        return tmesh.make_mesh(args[1], model_parallel=args[1])
    return tmesh.make_multislice_mesh(WORLD, replicas=args[1], model_parallel=args[2])


def _step(cfg, start, x, mesh=None, expert=False, zero1=False, spatial=False,
          inject=None, seed=None, optimizer="adamw"):
    """One train step of the layout from `start` on the global batch x:
    (loss, whole parameters, whole gradients, local moments, shards)."""
    unet = UNet(cfg, device="cpu")
    unet.load_state_dict(start)
    shards = dp = None
    if mesh is not None and spatial:
        dp = tmesh.spatial_parallel(unet, mesh, "cpu")
    elif mesh is not None:
        shards = tmesh.shard_params(unet, mesh, expert_parallel=expert)
        dp = mesh.data_parallel("cpu")
    z = tmesh.Zero1(list(unet.parameters()), dp, min_size=ZERO1_MIN) if zero1 else None
    tx = tsteps.make_optimizer(optimizer, LR, zero1=z, shards=shards)
    state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())))
    step = tsteps.make_ldm_train_step(unet, make_schedule(DDPMConfig()), tx,
                                      reduce_grads=dp)
    rows = slice(None) if mesh is None else tmesh.batch_rows(mesh, x.shape[0])
    xl = x[rows]
    if spatial:
        xl = xl[:, tmesh.spatial_rows(mesh, x.shape[0], x.shape[1])[1]]
    kw = {} if inject is None else dict(t=inject[0], eps=inject[1])
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    state, m = step(state, xl, generator=gen, **kw)
    if shards is None:
        params = {n: p.detach().clone() for n, p in unet.named_parameters()}
        grads = {n: p.grad.clone() for n, p in unet.named_parameters()}
    else:
        params, grads = shards.gathered(), shards.gathered(grads=True)
    mu = getattr(state.opt_state, "mu", None)
    return (m["loss"].item(), params, grads,
            None if mu is None else [t.clone() for t in mu], shards)


def _halo_attention(sp_mesh, inp) -> dict:
    """The spatial split's grouped conv (halo rows) and window attention
    (gathered map) on this rank's rows, forward and backward."""
    from ldm_image_generator_tpu_torch.models.layers import (
        GroupedConv2d,
        ParamInit,
        WindowAttention,
    )

    sp = tmesh.SpatialSplit(sp_mesh)
    init = ParamInit("cpu", torch.Generator().manual_seed(3))
    conv = GroupedConv2d(64, init)
    attn = WindowAttention(64, 2, init, window_size=6, shift=3)
    out = {}
    for name, fn in (("conv", lambda h: conv(sp.halo(h))[:, 1:-1]),
                     ("attn", lambda h: sp.own(attn(sp.gather(h))))):
        x = sp.own(inp["x"]).clone().requires_grad_()
        y = fn(x)
        (y * sp.own(inp["w"])).sum().backward()
        mod = conv if name == "conv" else attn
        grads = [p.grad.clone() for p in mod.parameters()]
        tmesh.all_reduce_sum(grads, torch.device("cpu"), sp.group)
        out[name] = dict(y=y.detach(), dx=x.grad, dparams=grads)
        mod.zero_grad()
    return out


def _adafactor_split(mesh, inp) -> dict:
    """Two Adafactor steps (clipped) on a parameter set split over the
    model group: the whole parameters after them."""
    from torch import nn

    mod = nn.Module()
    for n, v in inp["ada_params"].items():
        setattr(mod, n, nn.Parameter(v.clone()))
    shards = tmesh.shard_params(mod, mesh)
    params = list(mod.parameters())
    tx = tsteps.make_optimizer("adafactor", grad_clip=0.5, shards=shards)
    state = tx.init(params)
    for g in inp["ada_grads"]:
        local = [tensor_slice(g[n], shards, n) for n, _ in mod.named_parameters()]
        state = tx.apply(params, local, state)
    return shards.gathered()


def tensor_slice(t, shards, name):
    d = shards.plan[name]
    if d is None:
        return t.clone()
    k = t.shape[d] // shards.world
    return t.narrow(d, shards.rank * k, k).clone()


def _worker(rank: int, store_path: str, work: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        out = {"meshes": {}}
        meshes = {k: _make_mesh(v) for k, v in MESHES.items()}
        for k, m in meshes.items():
            if not m.member:
                with pytest.raises(ValueError, match="not in this mesh"):
                    m.group("model")
                out["meshes"][k] = dict(member=False)
                continue
            m.barrier()
            loader = BatchLoader(list(range(B)), B, group=m.data_group)
            out["meshes"][k] = dict(
                member=True, shape=m.shape, coords=m.coords, data_index=m.data_index,
                data_size=m.data_size, batch_rows=tmesh.batch_rows(m, B),
                spatial_rows=tmesh.spatial_rows(m, B, 16),
                loader_shard=(loader.shard_index, loader.shard_count))
        for lay in LAYOUTS:
            mesh = meshes["ms2x1x2" if lay["mesh"][0] == "multislice" else
                          f"mesh{lay['mesh'][1]}"]
            x, inject = ((inp["sp_x"], inp["sp_draws"]) if lay["spatial"]
                         else (inp["x"], inp["draws"]))
            loss, params, grads, mu, _ = _step(
                CFG, inp["start"], x, mesh, expert=lay["expert"], zero1=lay["zero1"],
                spatial=lay["spatial"], inject=inject)
            out[lay["name"]] = dict(loss=loss, params=params, grads=grads,
                                    mu_numel=[t.numel() for t in mu])
        # TP and EP at data 1 (model 4), routing and gates drawn
        for name, expert in (("tp4", False), ("ep4", True)):
            loss, params, grads, _, shards = _step(
                DRAWN, inp["drawn_start"], inp["drawn_x"], meshes["mesh4"],
                expert=expert, seed=5)
            out[name] = dict(loss=loss, params=params, grads=grads,
                             plan=shards.plan, expert=sorted(shards.expert))
        out["halo_attention"] = _halo_attention(meshes["mesh4"], inp["maps"])
        out["adafactor"] = _adafactor_split(meshes["mesh4"], inp)
        torch.save(out, os.path.join(work, f"out-{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- the test side ---------------------------------------------------------

def _jax_cfg():
    from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig

    return JUNetConfig(input_channels=4, stages=(1, 1), channels=(32, 256),
                       stochastic_depth=0.0, fixed_expert_indices=(0, 1))


def _jax_step(junet, params, x, key):
    """JAX's single-device AdamW step: (loss, {name: params}, {name: grad})
    with the gradient read back from the first moment (0.1 g)."""
    import jax
    import jax.numpy as jnp

    from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
    from ldm_image_generator_tpu.diffusion import ddpm as jddpm
    from ldm_image_generator_tpu.train import steps as jsteps
    from ldm_image_generator_tpu_torch.convert import flatten_tree

    tx = jsteps.make_optimizer("adamw", LR)
    state = jsteps.LDMTrainState(params=params, opt_state=tx.init(params),
                                 step=jnp.zeros((), jnp.int32))
    new, m = jax.jit(jsteps.make_ldm_train_step(
        junet, jddpm.make_schedule(JDDPMConfig()), tx))(state, jnp.asarray(x), key)
    flat = lambda tree: flatten_tree(jax.tree.map(np.asarray, tree)["params"])
    grads = {n: v.astype(np.float64) / 0.1 for n, v in flat(new.opt_state[0].mu).items()}
    return float(m["loss"]), flat(new.params), grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from ldm_image_generator_tpu.models import UNet as JUNet
    from ldm_image_generator_tpu_torch.convert import unet_from_flax
    from test_torch_port_train import _jax_draws

    work = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    junet = JUNet(_jax_cfg(), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    x = rng.normal(size=(B, HW, HW, 4)).astype(np.float32)
    sp_x = rng.normal(size=(SP_B, SP_HW, SP_HW, 4)).astype(np.float32)
    params = jax.jit(junet.init)({"params": key, "moe": key, "sd": key},
                                 jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32))
    k = jax.random.fold_in(key, 0)
    ref = dict(dp=_jax_step(junet, params, x, k), sp=_jax_step(junet, params, sp_x, k))
    start = unet_from_flax(jax.tree.map(np.asarray, params), CFG, device="cpu").state_dict()
    f32 = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    inputs = dict(
        start=start, x=torch.from_numpy(x), draws=_jax_draws(k, B, x.shape),
        sp_x=torch.from_numpy(sp_x), sp_draws=_jax_draws(k, SP_B, sp_x.shape),
        drawn_start=UNet(DRAWN, device="cpu",
                         generator=torch.Generator().manual_seed(1)).state_dict(),
        drawn_x=f32(4, HW, HW, 4),
        maps=dict(x=f32(2, 16, 16, 64), w=f32(2, 16, 16, 64)),
        ada_params=dict(k=f32(128, 512), v=f32(512, 256), e=f32(4, 32, 256), s=f32(8, 200)),
        ada_grads=[dict(k=f32(128, 512), v=f32(512, 256), e=f32(4, 32, 256),
                        s=f32(8, 200)) for _ in range(2)])
    torch.save(inputs, work / "inputs.pt")
    mp.start_processes(_worker, args=(str(work / "store"), str(work)), nprocs=WORLD,
                       start_method="spawn")
    ranks = [torch.load(work / f"out-{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(inputs=inputs, ranks=ranks, jax=ref)


def test_mesh_coordinates_and_stripes_match_jax(run):
    """Every rank sits at the coordinates of its device in JAX's mesh of
    the same shape over devices 0-3 (a mesh of 2 over the first two
    processes, as JAX's make_mesh(2) takes the first two devices; the
    others are no members and have no groups), its batch_rows /
    spatial_rows are the slices batch_sharding / spatial_sharding give
    that device, and a BatchLoader on the mesh's data group loads that
    stripe."""
    import jax

    from ldm_image_generator_tpu.parallel.mesh import (
        batch_sharding,
        make_mesh,
        make_multislice_mesh,
        spatial_sharding,
    )

    devices = jax.devices()[:WORLD]
    jax_meshes = {"mesh2": make_mesh(WORLD, 2, devices=devices),
                  "mesh4": make_mesh(WORLD, 4, devices=devices),
                  "ms2x2x1": make_multislice_mesh(WORLD, 2, 1, devices=devices),
                  "ms2x1x2": make_multislice_mesh(WORLD, 2, 2, devices=devices),
                  "first2": make_mesh(2, 2, devices=devices)}
    for name, jm in jax_meshes.items():
        batch = batch_sharding(jm, 4).devices_indices_map((B, 16, 16, 4))
        spatial = spatial_sharding(jm, 4).devices_indices_map((B, 16, 16, 4))
        for r, out in enumerate(run["ranks"]):
            got = out["meshes"][name]
            assert got["member"] == (devices[r] in batch), (name, r)
            if not got["member"]:
                continue
            assert got["shape"] == dict(jm.shape), name
            idx = tuple(got["coords"][a] for a in jm.axis_names)
            assert jm.devices[idx].id == r, (name, r)
            assert got["loader_shard"] == (got["data_index"], got["data_size"]), (name, r)
            dev = devices[r]
            assert got["batch_rows"] == slice(*batch[dev][0].indices(B)[:2]), (name, r)
            want = spatial[dev]
            assert got["spatial_rows"] == (slice(*want[0].indices(B)[:2]),
                                           slice(*want[1].indices(16)[:2])), (name, r)
    ms = run["ranks"][3]["meshes"]["ms2x2x1"]
    assert ms["coords"] == {"replica": 1, "data": 1, "model": 0} and ms["data_index"] == 3


class _ShapeOnly:
    """The mesh shape param_plan reads."""

    def __init__(self, model):
        self.shape = {"data": 1, "model": model}


@pytest.mark.parametrize("expert_parallel", [False, True])
def test_param_plan_matches_jax_shardings(expert_parallel):
    """param_plan on the tiny UNet at model size 2 puts 'model' on the
    dimension param_shardings(make_mesh(8, 2)) puts it on, leaf by leaf
    (None where replicated), for TP and for EP."""
    import jax
    import jax.numpy as jnp

    from ldm_image_generator_tpu.models import UNet as JUNet
    from ldm_image_generator_tpu.parallel.mesh import make_mesh, param_shardings

    junet = JUNet(_jax_cfg(), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(junet.init, {"params": key, "moe": key, "sd": key},
                            jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32))
    specs = param_shardings(params, make_mesh(8, model_parallel=2),
                            expert_parallel=expert_parallel)
    want = {".".join(k.key for k in path[1:]): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(specs)}
    plan = tmesh.param_plan(UNet(CFG, device="meta"), _ShapeOnly(2), expert_parallel)
    assert set(plan) == set(want)
    for n, spec in want.items():
        assert plan[n] == (spec.index("model") if "model" in spec else None), (n, spec)
    assert any(d is not None for d in plan.values())
    if expert_parallel:
        assert any(d == 0 for d in plan.values())


def test_default_unet_split_shares():
    """On the default UNet at model size 2: TP splits 383.5M of 385.7M
    parameters, EP the stacked experts on E (138.0M) and TP the rest
    (384.7M in all), so a rank keeps 0.503 (TP) or 0.501 (EP) of the
    parameters, and of their gradients and moments."""
    unet = UNet(UNetConfig(), device="meta")
    sizes = {n: p.numel() for n, p in unet.named_parameters()}
    total = sum(sizes.values())
    for ep, split_m, share in ((False, 383.5, 0.503), (True, 384.7, 0.501)):
        plan = tmesh.param_plan(unet, _ShapeOnly(2), ep)
        split = sum(sizes[n] for n, d in plan.items() if d is not None)
        kept = (total - split) + split / 2
        assert abs(split / 1e6 - split_m) < 0.1 and abs(kept / total - share) < 0.003
        if ep:
            experts = sum(sizes[n] for n, d in plan.items() if d == 0)
            assert abs(experts / 1e6 - 138.0) < 0.1


def _exempt(grads: dict, got_grads: dict) -> dict:
    """Elements whose JAX gradient is rounding, or which the port's
    gradient misses by more than test_torch_port_train's rule (a ReLU
    unit decided the other way): Adam moves them by about lr whatever
    their sign. At most EXEMPT_SHARE of them."""
    from test_torch_port_train import EXEMPT_SHARE, GRAD_ATOL, GRAD_RTOL, GRAD_ZERO

    ex = {}
    for n, g in grads.items():
        got = got_grads[n].numpy()
        ex[n] = ((np.abs(g) <= GRAD_ZERO) & ~((g == 0) & (got == 0))) | (
            np.abs(got - g) > GRAD_ATOL + GRAD_RTOL * np.abs(g))
    assert sum(int(e.sum()) for e in ex.values()) <= EXEMPT_SHARE * sum(
        e.size for e in ex.values())
    return ex


@pytest.mark.parametrize("layout", [lay["name"] for lay in LAYOUTS])
def test_layout_step_matches_jax_global_batch(run, layout):
    """Each layout's fp32 step: every rank's whole parameters equal, the
    loss within 1e-4 of JAX's single-device step on the global batch and
    the parameters at rtol 1e-3, atol 1e-5 (tests/test_parallel.py's
    tolerances; elements whose JAX gradient is rounding exempt). The
    gradients: within the DP tests' tolerance on the layouts that split
    the batch only; on the spatial split (whose halo conv and split FFN
    rows sum in other orders) by test_torch_port_train's rule, the
    elements it exempts few."""
    lay = next(lay for lay in LAYOUTS if lay["name"] == layout)
    ranks = run["ranks"]
    got = ranks[0][layout]
    for r in ranks[1:]:
        assert r[layout]["loss"] == got["loss"]
        for n, p in got["params"].items():
            assert torch.equal(r[layout]["params"][n], p), (layout, n)
    loss, params, grads = run["jax"]["sp" if lay["spatial"] else "dp"]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    exempt = _exempt(grads, got["grads"])
    for n, g in grads.items():
        if not lay["spatial"]:
            np.testing.assert_allclose(got["grads"][n].numpy(), g, err_msg=n, **GRAD_TOL)
        keep = ~exempt[n]
        np.testing.assert_allclose(got["params"][n].numpy()[keep], params[n][keep],
                                   err_msg=n, **PARAM_TOL)
    if lay["zero1"]:
        plain = ranks[0]["dp2_tp2"]
        assert plain["loss"] == got["loss"]
        for n, p in plain["params"].items():
            assert torch.equal(got["params"][n], p), n
        assert sum(got["mu_numel"]) < 0.75 * sum(plain["mu_numel"])
    if not lay["spatial"]:
        # each rank holds about half the moments of a whole model
        full = sum(p.numel() for p in run["inputs"]["start"].values())
        assert sum(ranks[0]["dp2_tp2"]["mu_numel"]) < 0.7 * full


@pytest.mark.parametrize("layout", ["tp4", "ep4"])
def test_tp_ep_at_data_one_are_one_process_bitwise(run, layout):
    """Model 4, data 1, routing and stochastic depth drawn from one seed:
    the loss, whole gradients and whole parameters of every rank bitwise
    the port's one-process step; EP splits the stacked experts one per
    rank."""
    inp = run["inputs"]
    loss, params, grads, _, _ = _step(DRAWN, inp["drawn_start"], inp["drawn_x"], seed=5)
    for r in run["ranks"]:
        got = r[layout]
        assert got["loss"] == loss
        for n in params:
            assert torch.equal(got["grads"][n], grads[n]), (layout, n)
            assert torch.equal(got["params"][n], params[n]), (layout, n)
    plan, expert = run["ranks"][0][layout]["plan"], run["ranks"][0][layout]["expert"]
    if layout == "ep4":
        assert expert and all(n.rsplit(".", 1)[-1] in ("wa", "wb", "wc") for n in expert)
        assert all(plan[n] == 0 for n in expert)
    else:
        assert not expert and any(d is not None for d in plan.values())


def test_halo_conv_and_gathered_attention_match_whole_map(run):
    """The grouped conv on each rank's 4 rows plus a one-row halo and
    window attention (window 6, shift 3) on the gathered map, each rank
    keeping its rows: the outputs, input gradients and (summed over the
    ranks) parameter gradients of the whole-map modules."""
    from ldm_image_generator_tpu_torch.models.layers import (
        GroupedConv2d,
        ParamInit,
        WindowAttention,
    )

    maps = run["inputs"]["maps"]
    init = ParamInit("cpu", torch.Generator().manual_seed(3))
    conv = GroupedConv2d(64, init)
    attn = WindowAttention(64, 2, init, window_size=6, shift=3)
    for name, mod in (("conv", conv), ("attn", attn)):
        x = maps["x"].clone().requires_grad_()
        y = mod(x)
        (y * maps["w"]).sum().backward()
        got = [r["halo_attention"][name] for r in run["ranks"]]
        torch.testing.assert_close(torch.cat([g["y"] for g in got], 1), y.detach(),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(torch.cat([g["dx"] for g in got], 1), x.grad,
                                   rtol=1e-5, atol=1e-5)
        for g in got:
            for a, p in zip(g["dparams"], mod.parameters()):
                torch.testing.assert_close(a, p.grad, rtol=1e-4, atol=1e-4)


def test_adafactor_on_split_parameters_matches_whole(run):
    """Two clipped Adafactor steps on parameters split over 4 ranks (a
    factored one split on its row axis, one on its column axis, a 3-D
    one, one left whole): the gathered parameters match the same steps on
    the whole tensors in one process."""
    from torch import nn

    inp = run["inputs"]
    mod = nn.Module()
    for n, v in inp["ada_params"].items():
        setattr(mod, n, nn.Parameter(v.clone()))
    params = list(mod.parameters())
    tx = tsteps.make_optimizer("adafactor", grad_clip=0.5)
    state = tx.init(params)
    for g in inp["ada_grads"]:
        state = tx.apply(params, [g[n] for n, _ in mod.named_parameters()], state)
    for r in run["ranks"]:
        for n, p in mod.named_parameters():
            torch.testing.assert_close(r["adafactor"][n], p.detach(), rtol=1e-5,
                                       atol=1e-6)


class _Split:
    """A SpatialSplit's fields without a process group."""

    def __init__(self, world):
        self.rank, self.world = 0, world

    check = tmesh.SpatialSplit.check


@pytest.mark.parametrize("rows,world,stage", [(12, 4, 0), (8, 4, 1), (6, 2, 0)])
def test_spatial_split_refuses_an_odd_stripe(rows, world, stage):
    """A split that leaves a stage an odd or empty stripe before its 2x
    downsampling is refused, naming the stage and the sizes."""
    unet = UNet(dataclasses.replace(CFG, stages=(1, 1, 1), channels=(32, 32, 32)),
                device="cpu")
    unet.spatial = _Split(world)
    x = torch.zeros((1, rows // world, 8, 4))
    with pytest.raises(ValueError, match=f"enc_stage_{stage} gets") as exc:
        unet(x, torch.ones((1,), dtype=torch.long))
    assert f"over {world} ranks" in str(exc.value)


def test_spatial_rows_refuses_an_uneven_height():
    class M:
        shape = {"data": 1, "model": 4}
        coords = {"data": 0, "model": 0}
        data_size, data_index = 1, 0

    with pytest.raises(ValueError, match="height 18 does not split over 4"):
        tmesh.spatial_rows(M(), 2, 18)
