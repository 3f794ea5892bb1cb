"""Latent diffusion sampling, the torch counterpart of
LDMPipeline.sample in ldm_image_generator_tpu/pipelines.py.

init noise -> DDIM over the UNet in latent space (FiLM schedule computed
once per call) -> VAE decode -> clamp -> uint8. The pipeline samples with
copies of the caller's modules cast to the compute dtype (and, with
ffn_quant='int8', their int8 FFN weights), made once per weight version
of those modules; the caller's modules are left as they are.
"""
from __future__ import annotations

import copy
import itertools
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


def weight_version(*modules) -> tuple:
    """A key that changes when a parameter or buffer of the modules is
    replaced or changed in place: each tensor's storage, dtype and
    in-place version counter."""
    return tuple((t.data_ptr(), t.dtype, t._version) for m in modules
                 for t in itertools.chain(m.parameters(), m.buffers()))


def cast_copy(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """`module` itself when its floating tensors are all in dtype, else a
    copy with them cast (each parameter cast straight into the copy, so
    the module is never held twice at its own width)."""
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    if all(t.dtype == dtype for t in tensors if t.is_floating_point()):
        return module
    memo = {id(p): torch.nn.Parameter(p.detach().to(dtype, copy=True),
                                      requires_grad=p.requires_grad)
            for p in module.parameters()}
    return copy.deepcopy(module, memo).to(dtype).eval()


class LDMPipeline:
    """Unconditional DDIM latent diffusion sampler over a UNet and a VAE
    Decoder. The caller's modules are not changed: the pipeline samples
    with copies cast to `dtype` (the modules themselves where they already
    are in it) and, with the UNet's ffn_quant='int8', their int8 FFN
    weights, all made here and made again only when the modules' weights
    change (memoized per weight version, as the JAX package's _PrepCache):
    a sample call of unchanged weights casts and quantizes nothing."""

    def __init__(self, unet: UNet, decoder: Decoder,
                 ddpm_cfg: DDPMConfig = DDPMConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        self.schedule = make_schedule(ddpm_cfg)
        self.prediction = ddpm_cfg.prediction
        self.dtype = dtype
        self._src = (unet, decoder)
        self._version = None
        self._prepare()

    def _prepare(self) -> None:
        """The cast copies (and int8 FFN weights) of the caller's modules'
        current weights, made unless this weight version has them."""
        version = weight_version(*self._src)
        if version == self._version:
            return
        self.unet, self.decoder = (cast_copy(m, self.dtype) for m in self._src)
        self.unet.prepare_ffn(self.dtype)
        self._version = version

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
        self._prepare()
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
