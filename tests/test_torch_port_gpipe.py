"""The port's GPipe pipeline (parallel/pipeline.py, pipelined_unet.py)
against the JAX package's (CPU, fp32; conftest's 8 virtual devices host
JAX's stages, and the CPU hosts every stage of the port's): the schedule
against sequential_apply with gradients, a pass-through stream leaf, the
pipelined UNet against JAX's pipelined_unet_apply and the plain UNet,
the pipelined train step, tiny_deep, and the trainer CLI."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.parallel import pipeline as jpipe
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig
from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.parallel.pipeline import pipeline_apply, sequential_apply
from ldm_image_generator_tpu_torch.parallel.pipelined_unet import PipelinedUNet, pipelined_blocks
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

# the JAX package's own tolerance for its pipelined UNet
UNET_TOL = dict(rtol=1e-4, atol=5e-5)


def dense_block(params, x):
    return torch.tanh(x @ params["w"] + params["b"]) + x


def _dense_stages(s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": torch.from_numpy((rng.normal(size=(d, d)) * 0.2).astype(np.float32)),
             "b": torch.from_numpy((rng.normal(size=(d,)) * 0.1).astype(np.float32))}
            for _ in range(s)]


@pytest.mark.parametrize("s,m", [(1, 1), (1, 2), (2, 2), (2, 4), (4, 4), (4, 8)])
def test_pipeline_matches_sequential_with_gradients(s, m):
    """pipeline_apply == sequential_apply, and their gradients, for S
    stages and M microbatches (JAX tests/test_pipeline_parallel.py
    test_pipeline_matches_sequential, test_pipeline_gradients_match_
    sequential, test_pipeline_single_stage_degenerates); the output is
    also JAX's pipeline_apply on an S-device stage mesh."""
    d = 16
    stages = _dense_stages(s, d)
    for p in stages:
        for v in p.values():
            v.requires_grad_(True)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2 * m, d)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(size=(2 * m, d)).astype(np.float32))
    y_pp = pipeline_apply(dense_block, stages, x, ["cpu"] * s, num_microbatches=m)
    g_pp = torch.autograd.grad(((y_pp - tgt) ** 2).mean(),
                               [v for p in stages for v in p.values()])
    y_seq = sequential_apply(dense_block, stages, x)
    g_seq = torch.autograd.grad(((y_seq - tgt) ** 2).mean(),
                                [v for p in stages for v in p.values()])
    np.testing.assert_allclose(y_pp.detach().numpy(), y_seq.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(g_pp, g_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    jparams = jpipe.stack_stage_params(
        [{k: jnp.asarray(v.detach().numpy()) for k, v in p.items()} for p in stages])
    jblock = lambda p, xx: jnp.tanh(xx @ p["w"] + p["b"]) + xx
    y_jax = jax.jit(lambda p, xx: jpipe.pipeline_apply(
        jblock, p, xx, jpipe.make_pipeline_mesh(s), num_microbatches=m))(
            jparams, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y_pp.detach().numpy(), np.asarray(y_jax),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_pytree_stream_passes_t_through():
    """An (x, t) stream: t rides with its microbatch and comes out
    unchanged (JAX test_pipeline_pytree_stream_with_data_axis)."""
    s, m, d = 2, 4, 16
    stages = _dense_stages(s, d)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(m * 2, d)).astype(np.float32))
    t = torch.arange(m * 2, dtype=torch.float32)[:, None]

    def block(p, stream):
        xx, tt = stream
        return (torch.tanh(xx @ p["w"] + p["b"]) + xx + 0.01 * tt, tt)

    y_pp, t_pp = pipeline_apply(block, stages, (x, t), ["cpu"] * s, num_microbatches=m)
    y_seq, t_seq = sequential_apply(block, stages, (x, t))
    np.testing.assert_allclose(y_pp.numpy(), y_seq.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(t_pp, t_seq) and torch.equal(t_pp, t)


def test_pipeline_checks_the_split():
    stages = _dense_stages(2, 4)
    with pytest.raises(ValueError, match="not divisible into 4 microbatches"):
        pipeline_apply(dense_block, stages, torch.zeros(6, 4), ["cpu"] * 2, 4)
    with pytest.raises(ValueError, match="1 devices for 2 stages"):
        pipeline_apply(dense_block, stages, torch.zeros(4, 4), ["cpu"], 2)


def _pipeline_test_cfgs():
    """JAX's _pipeline_test_cfg (tests/test_pipeline_parallel.py) in
    both packages."""
    kw = dict(input_channels=4, stages=(4, 2), channels=(16, 32), head_dim=8,
              stochastic_depth=0.0, fixed_expert_indices=(0, 1))
    return JUNetConfig(**kw), UNetConfig(**kw)


def test_pipelined_unet_matches_jax_and_plain():
    """The port's pipelined UNet at S=2 (the 4-block encoder stack and
    the decoder's 2-block prefix pipeline) against JAX's
    pipelined_unet_apply on a (stage 2, data 2) mesh and against the
    port's plain UNet, on the same parameters."""
    from ldm_image_generator_tpu.models.unet import UNet as JUNet
    from ldm_image_generator_tpu.parallel.pipelined_unet import pipelined_unet_apply
    from ldm_image_generator_tpu_torch.convert import unet_from_flax

    jcfg, tcfg = _pipeline_test_cfgs()
    junet = JUNet(jcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (4, 8, 8, jcfg.input_channels))
    t = jnp.array([3, 500, 999, 250], jnp.int32)
    params = jax.jit(junet.init)({"params": key, "moe": key}, x, t)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("stage", "data"))
    y_jax = jax.jit(lambda p, xx, tt: pipelined_unet_apply(
        jcfg, p, xx, tt, mesh, deterministic=True, dtype=jnp.float32))(params, x, t)
    unet = unet_from_flax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    pp = PipelinedUNet(unet, ["cpu", "cpu"])
    assert pp.pipelined() == {"enc_stage_0": 2, "enc_stage_1": 1, "dec_stage_0": 1}
    xt, tt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(t))
    with torch.no_grad():
        y_pp = pp(xt, tt)
        y_plain = unet(xt, tt)
    np.testing.assert_allclose(y_pp.numpy(), np.asarray(y_jax), **UNET_TOL)
    np.testing.assert_allclose(y_pp.numpy(), y_plain.numpy(), **UNET_TOL)


def test_pipelined_unet_draws_as_the_plain_forward():
    """Routing plan and stochastic-depth gates drawn from a generator,
    class ids on a conditioned UNet, remat on: the pipelined training
    forward gives the plain one's output, and its gradients."""
    cfg = dataclasses.replace(UNetConfig().tiny_deep(), num_classes=3, remat=True)
    unet = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pp = PipelinedUNet(unet, ["cpu"] * 2, num_microbatches=4)
    x = torch.randn(4, 8, 8, 8, generator=torch.Generator().manual_seed(1))
    t, cond = torch.tensor([5, 300, 600, 900]), torch.tensor([0, 3, 1, 2])
    outs, grads = [], []
    for fwd in (pp, unet):
        y = fwd(x, t, cond, generator=torch.Generator().manual_seed(2),
                deterministic=False)
        outs.append(y)
        grads.append(torch.autograd.grad(y.square().mean(), list(unet.parameters()),
                                         allow_unused=True))
    np.testing.assert_allclose(outs[0].detach().numpy(), outs[1].detach().numpy(), **UNET_TOL)
    for (n, _), a, b in zip(unet.named_parameters(), *grads):
        assert (a is None) == (b is None), n
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=n, **UNET_TOL)


def test_pipelined_train_step_matches_plain_loss():
    """make_ldm_train_step(apply_fn=the pipelined forward) gives the plain
    step's loss within 1e-4 and finite updated parameters (JAX
    test_pipelined_train_step_matches_plain_loss)."""
    _, tcfg = _pipeline_test_cfgs()
    start = UNet(tcfg, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    x = torch.randn(4, 8, 8, 4, generator=torch.Generator().manual_seed(1))
    losses = []
    for pipelined in (True, False):
        unet = UNet(tcfg, device="cpu")
        unet.load_state_dict(start)
        tx = tsteps.make_optimizer("adamw", 1e-4)
        state = tsteps.LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())))
        step = tsteps.make_ldm_train_step(
            unet, make_schedule(DDPMConfig()), tx, stochastic_depth=False,
            apply_fn=PipelinedUNet(unet, ["cpu"] * 2) if pipelined else None)
        state, m = step(state, x, generator=torch.Generator().manual_seed(3))
        losses.append(m["loss"].item())
        assert all(torch.isfinite(p).all() for p in unet.parameters())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


def test_tiny_deep_matches_jax():
    assert dataclasses.asdict(UNetConfig().tiny_deep()) == dataclasses.asdict(
        JUNetConfig().tiny_deep())
    assert pipelined_blocks(2, False, 2) == 2 and pipelined_blocks(1, True, 2) == 0


def test_default_unet_pipelines_as_jax_rule():
    """At S=3 the default UNet's encoder stacks (3/3/9/3) pipeline, its
    decoder prefixes (1/1/7/1) do not: 18 blocks in 3 stages."""
    got = {f"enc_stage_{i}": pipelined_blocks(n, False, 3) for i, n in enumerate((3, 3, 9, 3))}
    got.update({f"dec_stage_{i}": pipelined_blocks(n, True, 3)
                for i, n in enumerate((3, 3, 9, 3))})
    assert got == {"enc_stage_0": 3, "enc_stage_1": 3, "enc_stage_2": 9, "enc_stage_3": 3,
                   "dec_stage_0": 0, "dec_stage_1": 0, "dec_stage_2": 0, "dec_stage_3": 0}


def test_train_cli_tiny_deep_pipelined(tmp_path, capsys, monkeypatch):
    """cli.train_ldm --config tiny-deep --pipeline-stages 2 -d cpu trains
    (the first encoder stack pipelined, 2 microbatches) and saves."""
    from ldm_image_generator_tpu_torch.cli import train_ldm
    from test_torch_port_train import _images

    monkeypatch.chdir(tmp_path)
    state = train_ldm.main([_images(tmp_path), "--config", "tiny-deep", "-s", "32",
                            "-b", "2", "-e", "2", "-d", "cpu", "--pipeline-stages", "2",
                            "--ema", "0.9"])
    out = capsys.readouterr().out
    assert ("pipeline-parallel: 2 stages x 1 data shards, 2 microbatches "
            "(pipelined blocks per stage: {'enc_stage_0': 1})") in out
    assert "saved ./ddpm.pt, ./ddpm.pt.ema" in out
    assert (tmp_path / "ddpm.pt").stat().st_size > 0
    assert state.step == 4
    assert all(torch.isfinite(p).all() for p in state.params.parameters())
    assert not [line for line in out.splitlines() if line.startswith("{")
                and not np.isfinite(json.loads(line)["loss"])]
