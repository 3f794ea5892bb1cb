"""The plain reference against the port's plain path (CPU, float32, a
tiny UNet and decoder): the same weights, routing plans and
stochastic-depth keeps give the same UNet outputs, samples and train
steps. The reference imports nothing of the port; these tests import
both."""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, harness, program
from portbench import weights as W
from portbench.drivers import train as train_driver
from portbench.reference import sample as refs
from portbench.reference import train as reft
from portbench.reference import unet as ref

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def tiny(name: str, size: int = 32, dtype: str = "float32") -> dict:
    with open(CONFIGS / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["unet"].update(stages=[2, 1], channels=[32, 64])
    cfg["vae"].update(encoder_channels=[16, 32], encoder_stages=[1, 1],
                      decoder_channels=[32, 16], decoder_stages=[1, 1], num_embeddings=64)
    cfg.update(image_size=size, num_steps=4, compute_dtype=dtype)
    if cfg["unet"]["num_classes"]:
        cfg["unet"]["num_classes"] = 5
    return cfg


@pytest.mark.parametrize("name", ["ldm385m-512", "cin1000-256"])
def test_parameter_names_and_shapes_match_the_port(name):
    from ldm_image_generator_tpu_torch.config import VAEConfig
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.models.vae import Decoder

    with open(CONFIGS / f"{name}.json") as f:
        cfg = json.load(f)
    meta = torch.device("meta")
    unet = UNet(program.unet_config(cfg), device=meta)
    want = {n: tuple(p.shape) for n, p in unet.named_parameters()}
    assert {n: s for n, (s, _) in ref.unet_shapes(cfg["unet"]).items()} == want
    vcfg = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vae"].items()})
    dec = Decoder(vcfg, device=meta)
    want = {n: tuple(p.shape) for n, p in dec.named_parameters()}
    assert {n: s for n, (s, _) in ref.decoder_shapes(cfg["vae"]).items()} == want
    # the published size: 385.7M parameters in the unconditional UNet
    if name == "ldm385m-512":
        total = sum(np.prod(s) for s, _ in ref.unet_shapes(cfg["unet"]).values())
        assert round(total / 1e6, 1) == 385.7


@pytest.mark.parametrize("name,training", [("ldm385m-512", False), ("ldm385m-512", True),
                                           ("cin1000-256", False)])
def test_unet_forward_matches_the_port(name, training):
    torch.manual_seed(0)
    cfg = tiny(name)
    pipe, unet = program.pipeline(cfg, 7, torch.device("cpu"))
    P = {n: p.detach() for n, p in unet.named_parameters()}
    b = 3
    x = torch.randn(b, 32, 32, 8)
    g = torch.Generator().manual_seed(1)
    plan = torch.randint(0, 6, (len(ref.blocks(cfg["unet"])),), generator=g)
    t = torch.tensor([10, 500, 999]) if training else torch.tensor([250])
    keeps = torch.rand(len(plan), generator=g) > 0.25 if training else None
    cond = ids = None
    if cfg["unet"]["num_classes"]:
        ids = torch.tensor([0, 4, 5])
        cond = ref.class_tokens(P, cfg["unet"], ids)
    with torch.no_grad():
        got = unet(x, t, ids, moe_plan=plan, sd_gates=keeps, deterministic=not training)
        want = ref.unet(P, cfg["unet"], x, t, plan.tolist(),
                        None if keeps is None else keeps.float(), cond)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_sample_matches_the_port():
    cfg = tiny("cin1000-256")
    cfg["guidance_scale"] = 2.0
    pipe, unet = program.pipeline(cfg, 3, torch.device("cpu"))
    dec = pipe.decoder
    P = {n: p.detach() for n, p in unet.named_parameters()}
    D = {n: p.detach() for n, p in dec.named_parameters()}
    noise = torch.randn(2, 16, 16, 8, generator=torch.Generator().manual_seed(4))
    classes = torch.tensor([1, 3])
    imgs, z = pipe.sample(torch.Generator().manual_seed(9), batch=2, image_size=32,
                          num_steps=cfg["num_steps"], init_noise=noise, condition=classes,
                          guidance_scale=2.0, return_latent=True)
    want_imgs, want_z = refs.images(P, D, cfg, noise, 9, classes, 2.0)
    assert float(refs.latent_gap(z, want_z).max()) <= 1e-4
    assert float(refs.gaps(imgs, want_imgs)["mean_abs"].max()) <= 0.05


def test_train_steps_match_the_port():
    cfg = tiny("ldm385m-512")
    tr = {"batch": 4, "optimizer": "adamw", "learning_rate": 1e-3, "ema_decay": 0.999,
          "stochastic_depth": True, "check_steps": 2, "reference_block": 3}
    run = harness.Run(cell={}, cfg=cfg, traffic=tr, limits={}, seed=11, seconds=0.0,
                      trace=False, device=torch.device("cpu"), started=time.time())
    step, state, unet = program.trainer(cfg, tr, run.seed, run.device)
    names = [n for n, _ in unet.named_parameters()]
    feed = train_driver.feeder(run)
    p0 = {n: p.detach().clone() for n, p in unet.named_parameters()}
    prog = {"losses": []}
    for k in range(2):
        state, loss = step(state, *feed())
        prog["losses"].append(float(loss))
        if k == 0:
            prog["grad_norms"] = {n: float(m.norm()) / 0.1
                                  for n, m in zip(names, state.opt_state.mu)}
    params = {n: p.detach() for n, p in unet.named_parameters()}
    prog["change_norms"] = {n: float((params[n] - p0[n]).norm()) for n in names}
    prog["ema_change_norms"] = {n: float((state.ema_params[n] - p0[n]).norm()) for n in names}
    feed = train_driver.feeder(run)
    want = reft.steps(dict(p0), cfg, tr, [feed(), feed()], block=3)
    nums = compare.train_numbers(prog, want)
    assert nums["loss_gap"] <= 1e-5
    assert nums["grad_gap"] <= 1e-4
    assert nums["change_gap"] <= 1e-3
    assert nums["ema_gap"] <= 1e-3


def test_weights_are_the_seeds():
    shapes = ref.unet_shapes(tiny("ldm385m-512")["unet"])
    a = W.make(shapes, 2 ** 31 + 9, "unet", "cpu", torch.bfloat16)
    b = W.make(shapes, 2 ** 31 + 9, "unet", "cpu", torch.bfloat16)
    c = W.make(shapes, 2 ** 31 + 10, "unet", "cpu", torch.bfloat16)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["encoder_first.kernel"], c["encoder_first.kernel"])
    k = a["dec_stage_0.block_0.ffn.gwa"].float()
    assert abs(float(k.std()) - 32 ** -0.5) < 0.02
