"""The DiT pipeline under test, built from a configuration file (its
`dit`, `vae` and `ddpm` blocks) and the benchmark's weights: LDMPipeline
with the port's DiT in the UNet's place. With portbench/program.py and
program_spans.py, the modules of the harness that import the port; the
reference never imports it."""
from __future__ import annotations

import torch

from portbench import weights as W
from portbench.reference import dit as refdit
from portbench.reference import unet as ref


def pipeline(cfg: dict, seed: int, device):
    """(LDMPipeline in the configuration's compute dtype, its DiT): the DiT
    and the decoder hold the benchmark's weights (the DiT's from the
    "unet" stream, its pos_embed its own fixed table), already in the type
    they are served in, so the pipeline casts nothing."""
    from ldm_image_generator_tpu_torch.config import DDPMConfig, DiTConfig, VAEConfig
    from ldm_image_generator_tpu_torch.models.dit import DiT
    from ldm_image_generator_tpu_torch.models.vae import Decoder
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    dt = getattr(torch, cfg["compute_dtype"])
    dit = DiT(DiTConfig(**cfg["dit"]), device=device).to(dt)
    drawn = W.make(refdit.shapes(cfg["dit"]), seed, "unet", device, dt)
    dit.load_state_dict(dict(drawn, pos_embed=dit.pos_embed), strict=True)
    del drawn
    vcfg = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vae"].items()})
    dec = Decoder(vcfg, device=device).to(dt)
    dec.load_state_dict(W.make(ref.decoder_shapes(cfg["vae"]), seed, "decoder", device, dt),
                        strict=True)
    d = cfg["ddpm"]
    ddpm = DDPMConfig(beta_min=d["beta_min"], beta_max=d["beta_max"],
                      num_timesteps=d["num_timesteps"], loss=d["loss"],
                      prediction=d["prediction"])
    return LDMPipeline(dit, dec, ddpm, dtype=dt), dit
