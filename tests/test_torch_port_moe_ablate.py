"""The UNet's k-of-E routing (experts_per_call != 2) and branch ablation
(ablate_branches) against the JAX package (tiny config, CPU, fp32): a
forward with 3 experts per call (fixed, and drawn by JAX and injected),
the port's k-of-E draws, each of the five ablations and one pair, and the
parameter trees, which ablation leaves unchanged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu_torch.config import UNetConfig
from ldm_image_generator_tpu_torch.convert import flax_tree, unet_from_flax
from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.models.layers import SwinBlock
from ldm_image_generator_tpu_torch.models.unet import UNet

torch.set_num_threads(1)

# fp32 on the CPU (tests/test_models_parity.py)
TOL = dict(rtol=5e-4, atol=5e-5)
LATENT = 8
np_tree = lambda p: jax.tree.map(np.asarray, p)


def _random_params(junet, x, t, seed):
    """Parameters of the shapes junet.init makes (traced, not run),
    filled with seeded normals: biases at 0.05, every other tensor at 1 /
    sqrt(the product of its leading dimensions)."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(0)
    std = lambda shape: 0.05 if len(shape) == 1 else float(np.prod(shape[:-1])) ** -0.5
    return jax.tree.map(
        lambda a: jnp.asarray((rng.normal(size=a.shape) * std(a.shape)).astype(np.float32)),
        jax.eval_shape(junet.init, {"params": key, "moe": key}, x, t))


def _jax_forward(monkeypatch, jcfg, x, t, seed=6):
    """(params, the JAX UNet's output, the routing it drew): a plan of
    pair ids [plan_length] at experts_per_call 2, else the per-block
    expert ids [plan_length, k] of its jax.random.choice draws, in call
    order (the port's plan order)."""
    junet = JUNet(jcfg, dtype=jnp.float32)
    params = _random_params(junet, jnp.asarray(x), jnp.asarray(t), seed)
    draws = []
    randint, choice = jax.random.randint, jax.random.choice

    def rint(k, shape, *a, **kw):
        draws.append(randint(k, shape, *a, **kw))
        return draws[-1]

    def pick(k, n, shape=(), *a, **kw):
        draws.append(choice(k, n, shape, *a, **kw))
        return draws[-1]

    def apply(p, xx, tt, k):
        draws.clear()
        out = junet.apply(p, xx, tt, rngs={"moe": k})
        if not draws:
            return out, None
        return out, draws[0] if jcfg.experts_per_call == 2 else jnp.stack(draws)

    monkeypatch.setattr(jax.random, "randint", rint)
    monkeypatch.setattr(jax.random, "choice", pick)
    out, plan = jax.jit(apply)(params, jnp.asarray(x), jnp.asarray(t), jax.random.PRNGKey(7))
    monkeypatch.undo()
    return params, np.asarray(out), None if plan is None else np.array(plan)


def _inputs(batch=2):
    x = np.random.default_rng(5).normal(size=(batch, LATENT, LATENT, 8)).astype(np.float32)
    return x, np.asarray([613], np.int32)


def _launches():
    return (tbc.launches, tbc.int8_launches, tffn.launches, tffn.int8_launches)


@pytest.mark.parametrize("routing", ["fixed", "drawn"])
def test_three_experts_per_call_match_jax(monkeypatch, routing):
    """experts_per_call=3: fixed indices of length 3, or the routing JAX
    drew (3 distinct experts per block) injected as the plan. Every block
    runs the plain route, so no FFN wrapper is called."""
    over = dict(experts_per_call=3)
    if routing == "fixed":
        over["fixed_expert_indices"] = (0, 2, 3)
    x, t = _inputs()
    jcfg = dataclasses.replace(JUNetConfig().tiny(), **over)
    params, ref, plan = _jax_forward(monkeypatch, jcfg, x, t)
    tunet = unet_from_flax(np_tree(params),
                           dataclasses.replace(UNetConfig().tiny(), **over), device="cpu")
    if routing == "drawn":
        assert plan.shape == (tunet.plan_length(), 3)
        assert all(len(set(row)) == 3 for row in plan.tolist())
    else:
        assert plan is None
    before = _launches()
    with torch.no_grad():
        out = tunet(torch.from_numpy(x), torch.from_numpy(t),
                    moe_plan=None if plan is None else torch.from_numpy(plan))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # on the CPU the wrappers launch nothing either; the counts stay put
    assert _launches() == before


def test_k_of_e_draws_are_distinct_and_in_range():
    """draw_plan at k != 2: [plan_length, k] int32, k distinct ids per
    block in [0, E), every id drawn; at k = 2 pair ids as before; k
    outside 1..E is refused."""
    for k in (1, 3, 4):
        unet = UNet(dataclasses.replace(UNetConfig().tiny(), experts_per_call=k),
                    device="cpu", generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        plans = torch.cat([unet.draw_plan(gen) for _ in range(50)])
        assert plans.dtype == torch.int32 and plans.shape == (50 * unet.plan_length(), k)
        assert int(plans.min()) >= 0 and int(plans.max()) < 4
        assert all(len(set(row)) == k for row in plans.tolist())
        assert set(plans.flatten().tolist()) == {0, 1, 2, 3}
        routes = unet.routing(plans[:unet.plan_length()])
        assert [tuple(r.shape) for r in routes.values()] == [(1, k)] * 4
    unet = UNet(UNetConfig().tiny(), device="cpu")
    plan = unet.draw_plan(torch.Generator().manual_seed(1))
    assert plan.shape == (unet.plan_length(),) and int(plan.max()) < 6
    for k in (0, 5):
        with pytest.raises(ValueError, match="experts_per_call"):
            UNet(dataclasses.replace(UNetConfig().tiny(), experts_per_call=k), device="meta")


ABLATIONS = [("norm",), ("film",), ("moe",), ("conv",), ("attn",), ("film", "conv")]


@pytest.mark.parametrize("skip", ABLATIONS, ids=lambda s: "+".join(s))
def test_ablated_unet_matches_jax(monkeypatch, skip):
    """A forward with ablate_branches against the JAX UNet's (its XLA
    route; the routing plan it drew injected), batch 2. The port takes
    the kernels' wrappers only with norm, film and moe on: block_core
    with conv on as well, ffn_block with conv skipped; the plain
    composition otherwise."""
    x, t = _inputs()
    jcfg = dataclasses.replace(JUNetConfig().tiny(), ablate_branches=skip)
    params, ref, plan = _jax_forward(monkeypatch, jcfg, x, t)
    tcfg = dataclasses.replace(UNetConfig().tiny(), ablate_branches=skip)
    tunet = unet_from_flax(np_tree(params), tcfg, device="cpu")
    calls = {"block_core": 0, "ffn_block": 0}
    wrappers = {"block_core": tbc.block_core, "ffn_block": tffn.ffn_block}
    import ldm_image_generator_tpu_torch.models.layers as layers

    for name, fn in wrappers.items():
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=fn, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    with torch.no_grad():
        out = tunet(torch.from_numpy(x), torch.from_numpy(t),
                    moe_plan=torch.from_numpy(plan))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    blocks = tunet.plan_length()
    fused = not set(skip) & {"norm", "film", "moe"}
    want = {"block_core": blocks if fused and "conv" not in skip else 0,
            "ffn_block": blocks if fused and "conv" in skip else 0}
    assert calls == want, (calls, want)


def test_ablation_keeps_the_parameter_tree():
    """Every branch ablated, or 3 experts per call: the same parameter
    names and shapes as the default config's, and a JAX tree of the
    ablated config's shapes loads through unet_from_flax; SwinBlock
    refuses an unknown branch name."""
    base = UNet(UNetConfig().tiny(), device="cpu", generator=torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in base.state_dict().items()}
    for over in (dict(ablate_branches=("norm", "film", "moe", "conv", "attn")),
                 dict(experts_per_call=3), dict(ffn_quant="int8", experts_per_call=3,
                                                ablate_branches=("attn",))):
        cfg = dataclasses.replace(UNetConfig().tiny(), **over)
        unet = UNet(cfg, device="cpu")
        assert {n: tuple(p.shape) for n, p in unet.state_dict().items()} == shapes
        loaded = unet_from_flax(flax_tree(base), cfg, device="cpu")
        assert all(torch.equal(loaded.state_dict()[n], v) for n, v in base.state_dict().items())
        jcfg = dataclasses.replace(JUNetConfig().tiny(), **over)
        x, t = _inputs(1)
        jshapes = jax.eval_shape(JUNet(jcfg).init, {"params": jax.random.PRNGKey(0),
                                                   "moe": jax.random.PRNGKey(0)},
                                 jnp.asarray(x), jnp.asarray(t))
        flat = {".".join(str(getattr(k, "key", k)) for k in path[1:]): tuple(v.shape)
                for path, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
        assert flat == shapes
    with pytest.raises(ValueError, match="ablate_branches"):
        from ldm_image_generator_tpu_torch.models.layers import ParamInit

        SwinBlock(32, ParamInit("meta"), ablate_branches=("ffn",))


@pytest.mark.parametrize("over", [dict(ablate_branches=("film",)), dict(experts_per_call=3)])
def test_plain_route_trains_int8_straight_through(over):
    """The plain route with int8 FFN weights (ablation or k != 2) takes
    its gradients straight through to the fp32 parameters: the int8
    UNet's gradients equal those of the full-precision UNet on the
    dequantized weights."""
    cfg = dataclasses.replace(UNetConfig(ffn_quant="int8").tiny(), **over)
    unet = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    twin = UNet(dataclasses.replace(cfg, ffn_quant="none"), device="cpu")
    twin.load_state_dict(unet.state_dict())
    names = ("gwa", "gba", "gwb", "gbb", "gwc", "gbc", "wa", "ba", "wb", "bb", "wc", "bc")
    with torch.no_grad():
        for m, mt in zip((m for n, m in unet.named_modules() if n.endswith(".ffn")),
                         (m for n, m in twin.named_modules() if n.endswith(".ffn"))):
            for name, v in zip(names, m.ffn_weights(torch.float32, dequantized=True)[1][1]):
                getattr(mt, name).copy_(v)
    x, t = _inputs()
    plan = unet.draw_plan(torch.Generator().manual_seed(3))
    grads = []
    for m in (unet, twin):
        out = m(torch.from_numpy(x), torch.from_numpy(t), moe_plan=plan)
        out.square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    assert any(n.endswith("ffn.gwa") for n in grads[0])
    for n, g in grads[1].items():
        np.testing.assert_allclose(grads[0][n].numpy(), g.numpy(), err_msg=n, **TOL)
