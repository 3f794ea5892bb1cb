"""The program under test, built from a configuration file and the
benchmark's weights: the only module of the harness that imports the
port (ldm_image_generator_tpu_torch). The reference never imports it."""
from __future__ import annotations

import torch

from portbench import weights as W
from portbench.reference import unet as ref


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def unet_config(cfg: dict, **over):
    from ldm_image_generator_tpu_torch.config import UNetConfig

    u = dict(cfg["unet"])
    u.update(stages=tuple(u["stages"]), channels=tuple(u["channels"]), **over)
    return UNetConfig(**u)


def _load(module: torch.nn.Module, weights: dict) -> None:
    """The module's parameters set to the benchmark's weights (names and
    shapes must match exactly)."""
    module.load_state_dict(weights, strict=True)


def pipeline(cfg: dict, seed: int, device, int8: bool = False):
    """(LDMPipeline in the configuration's compute dtype, its UNet): the
    UNet and decoder hold the benchmark's weights, already in the type
    they are served in, so the pipeline casts nothing. int8: the UNet's
    int8 FFN weights (the program's lower-precision path, the control)."""
    from ldm_image_generator_tpu_torch.config import DDPMConfig, VAEConfig
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.models.vae import Decoder
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    dt = _dtype(cfg["compute_dtype"])
    ucfg = unet_config(cfg, ffn_quant="int8" if int8 else "none")
    vcfg = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vae"].items()})
    unet = UNet(ucfg, device=device).to(dt)
    _load(unet, W.make(ref.unet_shapes(cfg["unet"]), seed, "unet", device, dt))
    dec = Decoder(vcfg, device=device).to(dt)
    _load(dec, W.make(ref.decoder_shapes(cfg["vae"]), seed, "decoder", device, dt))
    d = cfg["ddpm"]
    ddpm = DDPMConfig(beta_min=d["beta_min"], beta_max=d["beta_max"],
                      num_timesteps=d["num_timesteps"], loss=d["loss"],
                      prediction=d["prediction"])
    return LDMPipeline(unet, dec, ddpm, dtype=dt), unet


def trainer(cfg: dict, traffic: dict, seed: int, device, int8: bool = False):
    """(step(state, x, t, eps, plan, keeps) -> (state, loss tensor), state,
    unet): make_ldm_train_step over a UNet with the benchmark's float32
    weights, AdamW and the EMA as the traffic file states."""
    from ldm_image_generator_tpu_torch.config import DDPMConfig
    from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.train.steps import (
        LDMTrainState,
        init_ema,
        make_ldm_train_step,
        make_optimizer,
    )

    ucfg = unet_config(cfg, ffn_quant="int8" if int8 else "none")
    unet = UNet(ucfg, device=device)
    _load(unet, W.make(ref.unet_shapes(cfg["unet"]), seed, "unet", device,
                       _dtype(cfg["param_dtype"])))
    d = cfg["ddpm"]
    schedule = make_schedule(DDPMConfig(beta_min=d["beta_min"], beta_max=d["beta_max"],
                                        num_timesteps=d["num_timesteps"]))
    tx = make_optimizer(traffic["optimizer"], traffic["learning_rate"])
    step_fn = make_ldm_train_step(unet, schedule, tx, loss=d["loss"],
                                  prediction=d["prediction"],
                                  stochastic_depth=traffic["stochastic_depth"],
                                  ema_decay=traffic["ema_decay"],
                                  dtype=_dtype(cfg["compute_dtype"]))
    params = list(unet.parameters())
    state = LDMTrainState(params=unet, opt_state=tx.init(params), ema_params=init_ema(unet))

    def step(state, x, t, eps, plan, keeps):
        state, m = step_fn(state, x, t=t, eps=eps, moe_plan=plan, sd_gates=keeps)
        return state, m["loss"]
    return step, state, unet


def serve_variants(pipe, size: int, num_steps: int):
    """make_variants of the port's serving CLI over the pipeline: the
    plain sampler at `size` (and ("cfg", size) for a conditional UNet)."""
    from ldm_image_generator_tpu_torch.cli.serve import make_variants

    return make_variants(pipe, [size], num_steps=num_steps)[0]


def sampler_server(variants: dict, traffic: dict, device):
    from ldm_image_generator_tpu_torch.serving import SamplerServer

    return SamplerServer(variants, batch_buckets=tuple(traffic["buckets"]),
                         max_wait_ms=traffic["max_wait_ms"],
                         max_queue=traffic["max_queue"], device=device)


def overloaded_error():
    from ldm_image_generator_tpu_torch.serving import ServerOverloaded

    return ServerOverloaded
