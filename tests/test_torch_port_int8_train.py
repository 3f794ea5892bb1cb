"""Training through int8 FFN weights, the port against the JAX package
(CPU, fp32): ffn_block and block_core gradients against jax.grad of the
JAX functions with quantized=True (their fake-quant XLA route), one int8
UNet train step against JAX's jitted make_ldm_train_step, the
straight-through identity (the same step on the dequantized weights
without quantization), the quantization count per step with and without
remat, and the gap to the JAX package's TPU backward (which recomputes at
the full-precision weights), reported. The CUDA side of the int8
backward is held on the card by tests/test_torch_port_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.diffusion import ddpm as jddpm
from ldm_image_generator_tpu.kernels import block_core as jbc
from ldm_image_generator_tpu.kernels import ffn_block as jffn
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.train import steps as jsteps
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig
from ldm_image_generator_tpu_torch.convert import flatten_tree, unet_from_flax
from ldm_image_generator_tpu_torch.diffusion import ddpm as tddpm
from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.models import layers
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

# fp32 on the CPU (tests/test_models_parity.py)
TOL = dict(rtol=5e-4, atol=5e-5)
LATENT = 8
LR = 1e-3
# Adam's first step moves each parameter by about lr * sign(g), so an
# element whose gradient is within rounding of 0, or whose two gradients
# differ beyond rounding, may step apart: the exemption rule of
# tests/test_torch_port_train.py's four-step test (GRAD_ZERO, GRAD_ATOL,
# GRAD_RTOL), which exempts at most EXEMPT_SHARE of the elements
GRAD_ZERO = 1e-5
GRAD_ATOL = 1e-6
GRAD_RTOL = 1e-2
EXEMPT_SHARE = 0.1
np_tree = lambda p: jax.tree.map(np.asarray, p)
flat = lambda tree: flatten_tree(np_tree(tree)["params"])


def _ffn_weights(c, m, e=4, seed=0):
    """The 12 FFN weights (lecun-scale matrices, random biases), fp32 numpy."""
    rng = np.random.default_rng(seed)
    w = lambda *s, fan: (rng.normal(size=s) / np.sqrt(fan)).astype(np.float32)
    b = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)
    return (w(c, m, fan=c), b(m), w(c, m, fan=c), b(m), w(m, c, fan=m), b(c),
            w(e, c, m, fan=c), b(e, m), w(e, c, m, fan=c), b(e, m),
            w(e, m, c, fan=m), b(e, c))


def _block_inputs(kernel, seed=3):
    """(x, film_mul, film_bias, the 12 weights[, conv kernel, conv bias]),
    fp32 numpy: ffn_block rows [32, 32], block_core a [2, 4, 4, 32] map
    with a batch-1 film."""
    rng = np.random.default_rng(seed)
    c = 32
    shape, film = ((2, 4, 4, c), (1, 4, 4, c)) if kernel == "block_core" else ((32, c),) * 2
    x = rng.normal(size=shape).astype(np.float32)
    mul = (rng.normal(size=film) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=film) * 0.2).astype(np.float32)
    conv = ()
    if kernel == "block_core":
        conv = ((rng.normal(size=(3, 3, 32, c)) * 0.1).astype(np.float32),
                (rng.normal(size=(c,)) * 0.1).astype(np.float32))
    return (x, mul, bias, *_ffn_weights(c, c, seed=seed + 1), *conv)


def _port_grads(kernel, inputs, g, ids, int8: bool):
    """The port's (out, h) and the gradients of sum(out * g) + sum(h) in
    every differentiable input, through the wrapper with int8 copies of
    the weights (int8) or on the weights as given."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    w = leaves[3:15]
    q = None
    if int8:
        qw = tffn.quantize_ffn(w)
        q = (qw, tffn.dequantize_ffn(qw, torch.float32))
    tids = torch.tensor(ids, dtype=torch.int32)
    if kernel == "ffn_block":
        out, h = tffn.ffn_block(*leaves, tids, int8=q)
    else:
        out, h = tbc.block_core(*leaves, tids, int8=q)
    loss = (out * torch.from_numpy(g)).sum() + h.sum()
    return out, h, torch.autograd.grad(loss, leaves)


def _jax_grads(kernel, inputs, g, ids, fn):
    """jax.grad (jitted) of sum(out * g) + sum(h) through fn(*inputs, ids)."""
    def loss(*a):
        out, h = fn(*a, jnp.asarray(ids, jnp.int32))
        return jnp.sum(out * g) + jnp.sum(h)
    return jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs)))))(
        *map(jnp.asarray, inputs))


@pytest.mark.parametrize("kernel", ["ffn_block", "block_core"])
def test_int8_gradients_match_jax(kernel):
    """With int8 copies and grad mode on, the wrapper's outputs and its
    gradients in all 15 (ffn_block) or 17 (block_core) differentiable
    inputs match jax.grad through the JAX function with quantized=True
    (fake_quantize: the backward at the dequantized weights, the weight
    gradients straight through)."""
    inputs = _block_inputs(kernel)
    g = np.random.default_rng(9).normal(size=inputs[0].shape).astype(np.float32)
    ids = (1, 3)
    jfn = {"ffn_block": jffn.ffn_block, "block_core": jbc.block_core}[kernel]
    out, h, grads = _port_grads(kernel, inputs, g, ids, int8=True)
    want_out, want_h = jax.jit(lambda *a: jfn(*a, quantized=True))(
        *map(jnp.asarray, inputs), jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), **TOL)
    want = _jax_grads(kernel, inputs, g, ids, lambda *a: jfn(*a, quantized=True))
    assert len(grads) == len(want) == (15 if kernel == "ffn_block" else 17)
    for i, (got, ref) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=f"input {i}",
                                   **TOL)
    # the routed experts' slices get gradients, the others none
    for stacked in grads[9:15]:
        assert stacked[[0, 2]].abs().max() == 0 and stacked[[1, 3]].abs().max() > 0


@pytest.mark.parametrize("kernel", ["ffn_block", "block_core"])
def test_int8_backward_gap_to_the_full_precision_recompute(kernel):
    """The JAX package's TPU backward of quantized=True (_ffb_bwd,
    _bc_bwd) recomputes at the full-precision weights; its CPU route and
    the port differentiate at the dequantized weights. The gap between
    the two, as each gradient's max abs difference over its max abs, is
    reported (it is the int8 rounding of the weights); only its
    finiteness is gated."""
    inputs = _block_inputs(kernel)
    g = np.random.default_rng(9).normal(size=inputs[0].shape).astype(np.float32)
    ids = (1, 3)
    _, _, grads = _port_grads(kernel, inputs, g, ids, int8=True)
    if kernel == "ffn_block":
        xla = lambda *a: jffn.ffn_block_xla(*a[:15], a[15][0], a[15][1])
    else:
        xla = lambda *a: jbc.block_core_xla(*a[:17], a[17][0], a[17][1])
    want = _jax_grads(kernel, inputs, g, ids, xla)
    gaps = []
    for got, ref in zip(grads, want):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        gaps.append(0.0 if scale == 0 else float(np.abs(got.numpy() - ref).max() / scale))
    print(f"{kernel}: int8 backward vs full-precision recompute, largest gap "
          f"{max(gaps):.3e} of max abs (per input: "
          + ", ".join(f"{v:.2e}" for v in gaps) + ")")
    assert np.isfinite(gaps).all() and max(gaps) > 0


def _recording(monkeypatch):
    """Record the routing plan (the plan-length randint) and the
    stochastic-depth uniforms (scalar) the JAX UNet draws inside a jit."""
    rec = {"plan": [], "sd": []}
    randint, uniform = jax.random.randint, jax.random.uniform

    def rint(k, shape, *a, **kw):
        out = randint(k, shape, *a, **kw)
        rec["plan"].append(out)
        return out

    def unif(k, shape=(), *a, **kw):
        out = uniform(k, shape, *a, **kw)
        if tuple(shape) == ():
            rec["sd"].append(out)
        return out

    monkeypatch.setattr(jax.random, "randint", rint)
    monkeypatch.setattr(jax.random, "uniform", unif)
    return rec


def _int8_setup(x, jcfg, tcfg, seed=0):
    """(JAX UNet, its params, the port UNet on those params)."""
    junet = JUNet(jcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    params = jax.jit(junet.init)({"params": key, "moe": key, "sd": key},
                                 jnp.asarray(x[:1]), jnp.zeros((1,), jnp.int32))
    return junet, params, unet_from_flax(np_tree(params), tcfg, device="cpu")


def _port_step(tunet, ema: bool = True):
    tx = tsteps.make_optimizer("adamw", LR)
    state = tsteps.LDMTrainState(params=tunet, opt_state=tx.init(list(tunet.parameters())),
                                 ema_params=tsteps.init_ema(tunet) if ema else None)
    step = tsteps.make_ldm_train_step(tunet, tddpm.make_schedule(DDPMConfig()), tx,
                                      ema_decay=0.9 if ema else None)
    return state, step


@pytest.mark.parametrize("batch", [4, 2])
def test_int8_unet_train_step_matches_jax(monkeypatch, batch):
    """One train step of a tiny UNet with ffn_quant='int8', routing drawn
    and stochastic depth on, through make_ldm_train_step (AdamW, EMA)
    against JAX's jitted make_ldm_train_step: t and noise, the routing
    plan and the stochastic-depth gates JAX drew injected. The loss, every
    gradient (read back from JAX's Adam first moment), the updated
    parameters and the EMA match; the parameters stay fp32. Batch 4 runs
    ffn_block, batch 2 block_core."""
    jcfg = JUNetConfig(ffn_quant="int8").tiny()
    tcfg = UNetConfig(ffn_quant="int8").tiny()
    x = np.random.default_rng(2).normal(size=(batch, LATENT, LATENT, 8)).astype(np.float32)
    junet, params, tunet = _int8_setup(x, jcfg, tcfg)
    jsched = jddpm.make_schedule(JDDPMConfig())
    jtx = jsteps.make_optimizer("adamw", LR)
    jstate = jsteps.LDMTrainState(params=params, opt_state=jtx.init(params),
                                  step=jnp.zeros((), jnp.int32),
                                  ema_params=jsteps.init_ema(params))
    jstep = jsteps.make_ldm_train_step(junet, jsched, jtx, ema_decay=0.9)
    key = jax.random.PRNGKey(5)
    rec = _recording(monkeypatch)

    def run(s, xx, k):
        out = jstep(s, xx, k)
        return out, rec["plan"][-1], jnp.stack(rec["sd"][-tunet.plan_length():])

    (jstate, jm), plan, u = jax.jit(run)(jstate, jnp.asarray(x), key)
    monkeypatch.undo()
    key_t, key_eps, _ = jax.random.split(key, 3)
    t = torch.from_numpy(np.array(jax.random.randint(key_t, (batch,), 1, 1000)))
    eps = torch.from_numpy(np.array(jax.random.normal(key_eps, x.shape)))
    gates = torch.from_numpy(np.array(u) > jcfg.stochastic_depth)
    assert 0 < int(gates.sum()) < gates.numel()
    tstate, tstep = _port_step(tunet)
    tstate, tm = tstep(tstate, torch.from_numpy(x), t=t, eps=eps,
                       moe_plan=torch.from_numpy(np.array(plan)), sd_gates=gates)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), **TOL)
    got = {n: p for n, p in tunet.named_parameters()}
    mu = flat(jstate.opt_state[0].mu)
    assert set(got) == set(mu)
    exempt = {}
    for n, m in mu.items():  # mu was 0: m = 0.1 g
        g_jax = m.astype(np.float64) / 0.1
        g = got[n].grad.numpy()
        np.testing.assert_allclose(g, g_jax, err_msg=n, **TOL)
        assert got[n].dtype == torch.float32
        zero = (np.abs(g_jax) <= GRAD_ZERO) & ~((g_jax == 0) & (g == 0))
        exempt[n] = zero | (np.abs(g - g_jax) > GRAD_ATOL + GRAD_RTOL * np.abs(g_jax))
    n_exempt = sum(int(e.sum()) for e in exempt.values())
    assert n_exempt <= EXEMPT_SHARE * sum(e.size for e in exempt.values())
    for what, ours, theirs in (("params", got, flat(jstate.params)),
                               ("ema", tstate.ema_params, flat(jstate.ema_params))):
        for n, v in theirs.items():
            keep = ~exempt[n]
            np.testing.assert_allclose(ours[n].detach().numpy()[keep], v[keep],
                                       err_msg=f"{what} {n}", **TOL)


def _dequantized_twin(tunet):
    """A full-precision UNet (ffn_quant='none') holding tunet's weights
    with each block's FFN weights replaced by their dequantized int8
    copies (as tunet's blocks make them for fp32 compute)."""
    twin = UNet(dataclasses.replace(tunet.cfg, ffn_quant="none"), device="cpu")
    twin.load_state_dict(tunet.state_dict())
    names = ("gwa", "gba", "gwb", "gbb", "gwc", "gbc", "wa", "ba", "wb", "bb", "wc", "bc")
    with torch.no_grad():
        for (_, m), (_, mt) in zip(
                ((n, m) for n, m in tunet.named_modules() if n.endswith(".ffn")),
                ((n, m) for n, m in twin.named_modules() if n.endswith(".ffn"))):
            _, (_, dq) = m.ffn_weights(torch.float32, dequantized=True)
            for name, v in zip(names, dq):
                getattr(mt, name).copy_(v)
    return twin


@pytest.mark.parametrize("batch", [4, 2])
def test_int8_step_is_straight_through(batch):
    """The straight-through identity: an int8 train step's loss and
    gradients equal those of the same step (same draws) of the
    full-precision UNet on the dequantized weights."""
    cfg = UNetConfig(ffn_quant="int8").tiny()
    tunet = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    twin = _dequantized_twin(tunet)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((batch, LATENT, LATENT, 8), generator=gen)
    draws = dict(t=torch.randint(1, 1000, (batch,), generator=gen),
                 eps=torch.randn(x.shape, generator=gen),
                 moe_plan=tunet.draw_plan(gen),
                 sd_gates=torch.rand(tunet.plan_length(), generator=gen) > 0.25)
    losses, grads = [], []
    for unet in (tunet, twin):
        state, step = _port_step(unet, ema=False)
        _, m = step(state, x, **draws)
        losses.append(m["loss"].item())
        grads.append({n: p.grad for n, p in unet.named_parameters()})
    np.testing.assert_allclose(losses[0], losses[1], **TOL)
    for n, g in grads[1].items():
        np.testing.assert_allclose(grads[0][n].numpy(), g.numpy(), err_msg=n, **TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_int8_step_quantizes_each_matrix_once(remat):
    """A train step quantizes each of a block's 6 matrices once (the
    optimizer then changes every weight version), a remat recompute
    quantizes nothing more, remat changes no gradient, and a forward of
    unchanged weights quantizes nothing."""
    cfg = dataclasses.replace(UNetConfig(ffn_quant="int8").tiny(), remat=remat)
    blocks = 2 * sum(cfg.stages)
    unet = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    plain = UNet(dataclasses.replace(cfg, remat=False), device="cpu")
    plain.load_state_dict(unet.state_dict())
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, LATENT, LATENT, 8), generator=gen)
    draws = dict(t=torch.randint(1, 1000, (4,), generator=gen),
                 eps=torch.randn(x.shape, generator=gen),
                 moe_plan=unet.draw_plan(gen),
                 sd_gates=torch.rand(unet.plan_length(), generator=gen) > 0.25)
    ref_state, ref_step = _port_step(plain)
    _, ref = ref_step(ref_state, x, **draws)
    state, step = _port_step(unet)
    for i in range(2):
        before = tffn.quantizations
        state, m = step(state, x, **draws)
        assert tffn.quantizations - before == 6 * blocks
        if i == 0:
            assert m["loss"].item() == ref["loss"].item()
            for (n, p), (_, q) in zip(unet.named_parameters(), plain.named_parameters()):
                assert torch.equal(p.grad, q.grad), n
    for made in (6 * blocks, 0):  # the weights the last step made, then unchanged
        before = tffn.quantizations
        with torch.no_grad():
            unet(x, draws["t"], moe_plan=draws["moe_plan"])
        assert tffn.quantizations - before == made


def test_int8_forward_without_grad_casts_nothing(monkeypatch):
    """With grad mode off an int8 block's kept int8 weights are all its
    forward needs: a memo hit casts none of the fp32 parameters to the
    compute dtype and gives the output of the int8 route; with grad mode
    on the weights come back cast and attached to the graph, the kept
    int8 weights reused."""
    unet = UNet(UNetConfig(ffn_quant="int8").tiny(), device="cpu",
                generator=torch.Generator().manual_seed(3))
    m = unet.enc_stage_0.block_0.ffn
    c = m.gwa.shape[0]
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((1, 4, 4, c), generator=gen).bfloat16()
    mul, bias = (torch.randn((1, 4, 4, c), generator=gen).bfloat16() for _ in range(2))
    ids = torch.tensor((0, 2), dtype=torch.int32)
    with torch.no_grad():
        w, (q, dq) = m.ffn_weights(torch.bfloat16)  # a miss: made here
        assert w is None and q[0].dtype == torch.int8 and dq is None
        casts = []
        real = layers.cast_all
        monkeypatch.setattr(layers, "cast_all", lambda ts, dt: (
            casts.extend(t for t in ts if any(t is p for p in m.parameters())),
            real(ts, dt))[1])
        before = tffn.quantizations
        out, h = m(x, mul, bias, expert_ids=ids)
        assert casts == [] and tffn.quantizations == before
        want = tffn.ffn_block_plain(x.reshape(-1, c), mul.reshape(-1, c),
                                    bias.reshape(-1, c), *q, ids)
    assert torch.equal(out.reshape(-1, c), want[0]) and torch.equal(h.reshape(-1, c), want[1])
    w, (q2, _) = m.ffn_weights(torch.bfloat16, dequantized=True)
    assert all(t.dtype == torch.bfloat16 and t.grad_fn is not None for t in w)
    assert all(a is b for a, b in zip(q, q2)) and tffn.quantizations == before


@pytest.mark.parametrize("optimizer", ["adamw", "radam", "adafactor"])
def test_int8_trains_with_every_optimizer(optimizer):
    """make_ldm_train_step runs an int8 UNet unchanged with each of the
    trainer's optimizers, conditioned (labels, cond-drop) and with EMA:
    finite losses, every fp32 parameter updated from a finite gradient,
    the FFN weights among them, and one quantization per matrix per
    step."""
    cfg = UNetConfig(ffn_quant="int8", num_classes=3).tiny()
    unet = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    tx = tsteps.make_optimizer(optimizer, LR)
    state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                                 ema_params=tsteps.init_ema(unet))
    step = tsteps.make_ldm_train_step(unet, tddpm.make_schedule(DDPMConfig()), tx,
                                      ema_decay=0.9, num_classes=3, cond_drop=0.5)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, LATENT, LATENT, 8), generator=gen)
    labels = torch.tensor([0, 1, 2, 1])
    start = {n: p.detach().clone() for n, p in unet.named_parameters()}
    for _ in range(2):
        before = tffn.quantizations
        state, m = step(state, x, generator=gen, labels=labels)
        assert tffn.quantizations - before == 6 * 2 * sum(cfg.stages)
        assert np.isfinite(m["loss"].item())
    params = dict(unet.named_parameters())
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in params.values())
    assert not torch.equal(params["enc_stage_0.block_0.ffn.gwa"],
                           start["enc_stage_0.block_0.ffn.gwa"])
    assert all(torch.isfinite(e).all() for e in state.ema_params.values())
