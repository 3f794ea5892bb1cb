"""Latent diffusion sampling, the torch counterpart of
LDMPipeline.sample in ldm_image_generator_tpu/pipelines.py.

init noise -> DDIM over the UNet in latent space (FiLM schedule computed
once per call) -> VAE decode -> clamp -> uint8. The pipeline casts its
modules to the compute dtype once, at construction.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ldm_image_generator_tpu_torch.config import (
    DDPMConfig,
    UNetConfig,
    VAEConfig,
    resolve_device,
)
from ldm_image_generator_tpu_torch.diffusion.ddpm import ddim_sample, make_schedule
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import Decoder


def film_schedule_ts(num_timesteps: int, num_steps: int,
                     steps=None) -> np.ndarray:
    """The ascending int32 timesteps a sampler run visits: the linspace
    derived from num_steps, or the deduplicated explicit `steps`."""
    if steps is None:
        return np.linspace(0, num_timesteps - 1, num_steps).astype(np.int32)
    return np.asarray(sorted(set(int(s) for s in steps)), dtype=np.int32)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float NHWC -> uint8 (clamp * 127.5 + 127.5, truncated)."""
    img = img.float().clamp(-1.0, 1.0)
    return (img * 127.5 + 127.5).to(torch.uint8)


class LDMPipeline:
    """Unconditional DDIM latent diffusion sampler over a UNet and a VAE
    Decoder. Both modules are cast to `dtype` in place."""

    def __init__(self, unet: UNet, decoder: Decoder,
                 ddpm_cfg: DDPMConfig = DDPMConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        self.unet = unet.to(dtype).eval()
        self.decoder = decoder.to(dtype).eval()
        self.schedule = make_schedule(ddpm_cfg)
        self.prediction = ddpm_cfg.prediction
        self.dtype = dtype

    @classmethod
    def random(cls, unet_cfg: UNetConfig = UNetConfig(),
               vae_cfg: VAEConfig = VAEConfig(),
               ddpm_cfg: DDPMConfig = DDPMConfig(),
               dtype: torch.dtype = torch.bfloat16, device="cuda",
               seed: int = 0) -> "LDMPipeline":
        """A pipeline with seeded random weights (no checkpoint)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        unet = UNet(unet_cfg, device=dev, generator=gen)
        decoder = Decoder(vae_cfg, device=dev, generator=gen)
        return cls(unet, decoder, ddpm_cfg, dtype)

    @property
    def device(self) -> torch.device:
        return self.unet.encoder_first.kernel.device

    def denoise_fn(self, latent: int, num_steps: int, steps=None,
                   film_cache: bool = True,
                   generator: Optional[torch.Generator] = None):
        """denoise(x, t) -> fp32 model output. With film_cache the FiLM
        towers run once here for every sampler timestep and each step
        replays its slice; a timestep outside that schedule raises."""
        dev = self.device
        routing_gen = (None if self.unet.cfg.fixed_expert_indices is not None
                       else generator)
        if not film_cache:
            def denoise(x, t):
                t_vec = torch.full((1,), t, dtype=torch.int32, device=dev)
                return self.unet(x, t_vec, generator=routing_gen).float()
            return denoise

        ts = film_schedule_ts(self.schedule.num_timesteps, num_steps, steps)[::-1]
        films = self.unet.collect_film(
            torch.as_tensor(ts.copy(), device=dev), (latent, latent))
        index = {int(t): i for i, t in enumerate(ts)}

        def denoise(x, t):
            i = index.get(int(t))
            if i is None:
                raise KeyError(f"timestep {t} is not in the FiLM schedule "
                               f"{sorted(index)}")
            film = {stage: {blk: (mul[i:i + 1], bias[i:i + 1])
                            for blk, (mul, bias) in blocks.items()}
                    for stage, blocks in films.items()}
            t_vec = torch.full((1,), t, dtype=torch.int32, device=dev)
            return self.unet(x, t_vec, film=film, generator=routing_gen).float()
        return denoise

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None,
               batch: int = 1, image_size: int = 256, num_steps: int = 20,
               eta: float = 0.0, film_cache: bool = True,
               init_noise: Optional[torch.Tensor] = None,
               steps: Optional[Sequence[int]] = None,
               return_latent: bool = False):
        """uint8 images [batch, image_size, image_size, 3] (and the final
        latent with return_latent). `generator` (on the pipeline's
        device) draws x_T unless init_noise is given, the per-step noise
        at eta > 0, and the MoE routing unless the config fixes it."""
        latent = image_size // self.decoder.cfg.downscale
        shape = (batch, latent, latent, self.unet.cfg.input_channels)
        denoise = self.denoise_fn(latent, num_steps, steps, film_cache,
                                  generator)
        z = ddim_sample(denoise, self.schedule, shape, generator=generator,
                        num_steps=num_steps, eta=eta, steps=steps,
                        init_noise=init_noise, prediction=self.prediction,
                        device=self.device)
        img = to_uint8(self.decoder(z))
        return (img, z) if return_latent else img
