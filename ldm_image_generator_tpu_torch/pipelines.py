"""Diffusion sampling, the torch counterpart of LDMPipeline.sample,
LDMPipeline.img2img and DDPMPipeline.sample in
ldm_image_generator_tpu/pipelines.py.

LDMPipeline: init noise -> DDIM or DPM-Solver++(2M) over the denoiser (a
UNet, or a DiT in its place) in latent space -> VAE decode -> clamp ->
uint8; optionally class-conditional with classifier-free guidance
(per-sample scales and rescale, a negative class) or with DeepCache
deep-feature reuse (UNet only). img2img encodes an image
with the VAE encoder, diffuses it part of the way and samples over the
rest of the schedule, optionally keeping a masked region (inpainting).
DDPMPipeline: the same samplers and DeepCache over a 3-channel UNet in
pixel space -> clamp -> uint8, no VAE.
Both sample with copies of the caller's modules cast to the compute dtype
(and, with ffn_quant='int8', their int8 FFN weights), made once per
weight version of those modules, and memoize the FiLM schedule per
(weight version, map size, num_steps, steps), as the JAX package's
_PrepCache does (the shared _Pipeline base); the caller's modules are
left as they are.
"""
from __future__ import annotations

import collections
import copy
import itertools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ldm_image_generator_tpu_torch.config import (
    DDPMConfig,
    UNetConfig,
    VAEConfig,
    resolve_device,
)
from ldm_image_generator_tpu_torch.diffusion.ddpm import (
    ddim_sample,
    film_schedule_ts,
    make_schedule,
    q_sample,
)
from ldm_image_generator_tpu_torch.diffusion.dpm_solver import dpm_solver_sample
from ldm_image_generator_tpu_torch.models.dit import DiT
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import Decoder, Encoder
from ldm_image_generator_tpu_torch.utils.profiling import span

SAMPLERS = ("ddim", "dpm++2m")
# FiLM schedules kept per weight version (the JAX package's _PREP_FILM_MAX)
FILM_MEMO_MAX = 4


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


def guide(pred_c: torch.Tensor, pred_u: torch.Tensor, scale,
          rescale) -> torch.Tensor:
    """Classifier-free guidance pred_u + scale (pred_c - pred_u); with a
    rescale phi (a float > 0, or a [B, 1, 1, 1] tensor whose 0 rows are
    exact no-ops) the guided prediction's per-sample std is brought back
    to the conditional one's and blended phi * rescaled + (1 - phi) *
    guided (arXiv:2305.08891 section 3.4)."""
    guided = pred_u + scale * (pred_c - pred_u)
    if isinstance(rescale, torch.Tensor) or rescale > 0.0:
        dims = tuple(range(1, guided.ndim))
        std_c = pred_c.std(dim=dims, keepdim=True, correction=0)
        std_g = guided.std(dim=dims, keepdim=True, correction=0)
        rescaled = guided * (std_c / (std_g + 1e-6))
        guided = rescale * rescaled + (1.0 - rescale) * guided
    return guided


def resize_mask(mask: torch.Tensor, latent: int) -> torch.Tensor:
    """A pixel mask [B, H, W, 1] resized to the latent grid [B, latent,
    latent, 1] in fp32: bilinear with half-pixel centres, antialiased when
    shrinking, as the JAX package's jax.image.resize(..., "linear")."""
    m = F.interpolate(mask.float().permute(0, 3, 1, 2), size=(latent, latent),
                      mode="bilinear", antialias=True, align_corners=False)
    return m.permute(0, 2, 3, 1)


def img2img_steps(num_timesteps: int, strength: float, num_steps: int) -> tuple:
    """The ascending timesteps img2img samples over: t_start =
    strength (T - 1) rounded (at least 1), round(strength num_steps) (at
    least 2) points of linspace(0, t_start) truncated to int, deduplicated."""
    t_start = max(1, int(round(strength * (num_timesteps - 1))))
    n = max(2, int(round(strength * num_steps)))
    return tuple(np.unique(np.linspace(0, t_start, n).astype(np.int32)).tolist())


def inpaint_projection(schedule, z0: torch.Tensor, m: torch.Tensor):
    """project_fn(x, t_next, final, noise) of ddim_sample for inpainting:
    the known latent z0 diffused to t_next with `noise` (z0 itself on the
    final step) where the latent mask m is 0, x where it is 1."""
    def project(x, t_next, final, noise):
        known = z0 if final else q_sample(
            schedule, z0, torch.full((z0.shape[0],), t_next, dtype=torch.int32,
                                     device=z0.device), noise)
        return m * x + (1.0 - m) * known
    return project


class _Pipeline:
    """What the pipelines share: the schedule, cast copies of the caller's
    modules (the denoiser first) made once per weight version, the FiLM
    schedule memo, the denoiser call at a timestep under a routing plan
    (_base_fn), the plan draw (_plan_fn), the sampler's model call, plain
    or guided (_denoise_fns), DeepCache's pair of calls and the sampler
    run. A subclass takes the copies in _adopt.

    The denoiser (`self.unet`: a UNet, or for LDMPipeline a DiT) gives the
    pipeline cfg.input_channels and cfg.num_classes (the null class id of
    CFG), prepare(dtype) (what a sampling run derives once per weight
    version: the UNet's int8 FFN weights), draw_fn(generator) (a step's
    routing plan, or None), tokens(latent) (per row, for the spans) and
    takes_film. takes_film True: each call gets one step's slice of the
    FiLM memo (collect_film), the routing plan and DeepCache's features;
    False: the call is denoiser(x, t, condition) and the prediction is
    its first cfg.input_channels channels (a DiT's learned variance is
    dropped: DDIM and DPM-Solver++ take the eps alone), no FiLM memo and
    no DeepCache. Each is read once per sampler run, never per call."""

    def __init__(self, modules: tuple, ddpm_cfg: DDPMConfig, dtype: torch.dtype):
        self.schedule = make_schedule(ddpm_cfg)
        self.prediction = ddpm_cfg.prediction
        self.dtype = dtype
        self._src = modules
        self._version = None
        # (weight version, map size, num_steps, steps) -> (index, films), LRU
        self._films = collections.OrderedDict()
        self._prepare()

    def _adopt(self, copies: list) -> None:
        self.unet = copies[0]

    def _prepare(self) -> None:
        """The cast copies (and int8 FFN weights) of the caller's modules'
        current weights, made unless this weight version has them."""
        version = weight_version(*self._src)
        if version == self._version:
            return
        self._adopt([cast_copy(m, self.dtype) for m in self._src])
        self.unet.prepare(self.dtype)
        self.device = next(self.unet.parameters()).device
        self._version = version
        # a version counter only grows: the old weights' schedules never hit
        self._films.clear()

    def film_schedule(self, latent: int, num_steps: int, steps=None) -> tuple:
        """({timestep: row}, {stage: {block: (mul, bias)}} of [S, h, w, c])
        for every timestep of a sampler run, collected once per (weight
        version, latent, num_steps, steps) and kept (LRU of
        FILM_MEMO_MAX)."""
        self._prepare()
        steps = None if steps is None else tuple(int(s) for s in steps)
        key = (self._version, latent, num_steps, steps)
        hit = self._films.get(key)
        if hit is not None:
            self._films.move_to_end(key)
            return hit
        ts = film_schedule_ts(self.schedule.num_timesteps, num_steps, steps)[::-1]
        films = self.unet.collect_film(
            torch.as_tensor(ts.copy(), device=self.device), (latent, latent))
        hit = self._films[key] = ({int(t): i for i, t in enumerate(ts)}, films)
        while len(self._films) > FILM_MEMO_MAX:
            self._films.popitem(last=False)
        return hit

    def _base_fn(self, latent: int, num_steps: int, steps, film_cache: bool):
        """base(x, t, plan, condition=None, deep=None, with_deep=False,
        branch="plain") -> the denoiser's fp32 prediction (and deep
        features) at the integer timestep t under the routing plan, in a
        span pipeline.unet (attrs rows, tokens per row, branch: plain, or
        CFG's cond / uncond). With film_cache each UNet step replays its
        slice of the FiLM schedule; a timestep outside it raises."""
        self._prepare()
        unet, dev = self.unet, self.device
        tokens = unet.tokens(latent)
        index, films = (self.film_schedule(latent, num_steps, steps)
                        if film_cache and unet.takes_film else (None, None))

        def base(x, t, plan, condition=None, deep=None, with_deep=False,
                 branch="plain"):
            with span("pipeline.unet", rows=x.shape[0], tokens=tokens, branch=branch):
                return call(x, t, plan, condition, deep, with_deep)

        def call_unet(x, t, plan, condition, deep, with_deep):
            film = None
            if films is not None:
                i = index.get(int(t))
                if i is None:
                    raise KeyError(f"timestep {t} is not in the FiLM schedule "
                                   f"{sorted(index)}")
                film = {stage: {blk: (mul[i:i + 1], bias[i:i + 1])
                                for blk, (mul, bias) in blocks.items()}
                        for stage, blocks in films.items()}
            t_vec = torch.full((1,), t, dtype=torch.int32, device=dev)
            out = unet(x, t_vec, condition, film=film, moe_plan=plan, deep=deep,
                       with_deep=with_deep)
            return (out[0].float(), out[1]) if with_deep else out.float()

        eps = unet.cfg.input_channels

        def call_eps(x, t, plan, condition, deep, with_deep):
            t_vec = torch.full((1,), t, dtype=torch.int32, device=dev)
            return unet(x, t_vec, condition)[..., :eps].float()

        call = call_unet if unet.takes_film else call_eps
        return base

    def _plan_fn(self, generator: Optional[torch.Generator]):
        """draw() -> one step's routing plan from `generator`, or None
        (the config fixes the experts, or the denoiser routes nothing)."""
        return self.unet.draw_fn(generator)

    def _denoise_fns(self, latent: int, num_steps: int, steps=None,
                    film_cache: bool = True,
                    generator: Optional[torch.Generator] = None,
                    condition: Optional[torch.Tensor] = None,
                    guidance_scale=1.0, cfg_rescale=0.0,
                    negative_condition: Optional[torch.Tensor] = None):
        """(denoise(x, t), step(x, t, condition=None, deep=None,
        with_deep=False), use_cfg): the sampler's model call, plain or with
        classifier-free guidance, and the unguided UNet call under a plan
        drawn per call.

        CFG applies when integer class ids are given to a class-conditional
        UNet and guidance_scale (a float, or a per-sample [B] tensor) is
        not 1.0: each step runs the UNet on `condition` and on the null
        class, or on `negative_condition` ids [B] (the null id is a
        per-sample no-op), both under one plan, and combines them with
        `guide` (cfg_rescale: a float or a per-sample [B] tensor)."""
        base = self._base_fn(latent, num_steps, steps, film_cache)
        draw = self._plan_fn(generator)
        dev = self.device
        per_sample = isinstance(guidance_scale, torch.Tensor)
        cfg = self.unet.cfg
        if condition is not None:
            condition = condition.to(dev)
        use_cfg = (condition is not None and not condition.is_floating_point()
                   and cfg.num_classes > 0 and (per_sample or guidance_scale != 1.0))

        def step(x, t, condition=None, deep=None, with_deep=False):
            return base(x, t, draw(), condition, deep, with_deep)

        if not use_cfg:
            return (lambda x, t: step(x, t, condition)), step, False
        per_sample_dims = lambda v: v.to(dev, torch.float32).reshape(-1, 1, 1, 1)
        scale = per_sample_dims(guidance_scale) if per_sample else guidance_scale
        rescale = (per_sample_dims(cfg_rescale) if isinstance(cfg_rescale, torch.Tensor)
                   else cfg_rescale)
        baseline = (torch.full_like(condition, cfg.num_classes)
                    if negative_condition is None
                    else negative_condition.to(dev, condition.dtype))

        def denoise(x, t):
            plan = draw()
            pred_c = base(x, t, plan, condition, branch="cond")
            pred_u = base(x, t, plan, baseline, branch="uncond")
            return guide(pred_c, pred_u, scale, rescale)
        return denoise, step, True

    def denoise_fn(self, latent: int, num_steps: int, steps=None,
                   film_cache: bool = True,
                   generator: Optional[torch.Generator] = None, **guidance):
        """denoise(x, t) -> fp32 model output (see _denoise_fns)."""
        return self._denoise_fns(latent, num_steps, steps, film_cache, generator,
                                **guidance)[0]

    def _deep_cache(self, step, cache_interval: int, condition=None):
        """ddim_sample's deep_cache for DeepCache at cache_interval > 1
        (fresh and cached calls of `step`, the unguided UNet call), else
        None."""
        if cache_interval < 1:
            raise ValueError(f"cache_interval {cache_interval}: 1 (off) or more")
        if cache_interval == 1:
            return None
        if not self.unet.takes_film:
            raise ValueError(f"cache_interval > 1 (DeepCache) needs a UNet: a "
                             f"{type(self.unet).__name__} has no deep core to reuse")
        if len(self.unet.cfg.stages) < 2:
            raise ValueError("cache_interval > 1 needs a UNet with >= 2 stages")
        return (lambda x, t: step(x, t, condition, with_deep=True),
                lambda x, t, deep: step(x, t, condition, deep=deep),
                cache_interval)

    def _run(self, sampler: str, denoise, shape, eta: float = 0.0,
             project_fn=None, project_noise=None, **run) -> torch.Tensor:
        """The final fp32 sample of `sampler` over denoise(x, t); `run`:
        generator, num_steps, steps, init_noise, deep_cache."""
        run.update(prediction=self.prediction, device=self.device)
        if sampler == "dpm++2m":
            return dpm_solver_sample(denoise, self.schedule, shape, **run)
        return ddim_sample(denoise, self.schedule, shape, eta=eta,
                           project_fn=project_fn, project_noise=project_noise, **run)


def check_sampler(sampler: str) -> None:
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r}: one of {SAMPLERS}")


class LDMPipeline(_Pipeline):
    """Latent diffusion sampler over a UNet (or a DiT) and a VAE Decoder:
    DDIM or DPM-Solver++(2M), unconditional or class-conditional (with
    CFG), and DeepCache (UNet only). The caller's modules are not
    changed: the pipeline samples
    with copies cast to `dtype` (the modules themselves where they already
    are in it) and, with the UNet's ffn_quant='int8', their int8 FFN
    weights, all made here and made again only when the modules' weights
    change (memoized per weight version, as the JAX package's _PrepCache):
    a sample call of unchanged weights casts and quantizes nothing, and
    collects no FiLM schedule it has collected before.

    MoE routing: each denoise step draws one routing plan from the
    sampling generator (unless the config fixes the experts); both CFG
    branches of a step take that plan, as the JAX package passes one key
    to both. `encoder` (a VAE Encoder) is needed by img2img only; its cast
    copy is memoized with the others'."""

    def __init__(self, unet: "UNet | DiT", decoder: Decoder,
                 ddpm_cfg: DDPMConfig = DDPMConfig(),
                 dtype: torch.dtype = torch.bfloat16,
                 encoder: Optional[Encoder] = None):
        super().__init__((unet, decoder) + ((encoder,) if encoder is not None else ()),
                         ddpm_cfg, dtype)

    def _adopt(self, copies: list) -> None:
        self.unet, self.decoder, *enc = copies
        self.encoder = enc[0] if enc else None

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

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None,
               batch: int = 1, image_size: int = 256, num_steps: int = 20,
               eta: float = 0.0, film_cache: bool = True,
               init_noise: Optional[torch.Tensor] = None,
               steps: Optional[Sequence[int]] = None,
               return_latent: bool = False, sampler: str = "ddim",
               condition: Optional[torch.Tensor] = None,
               guidance_scale: float = 1.0,
               guidance_scales: Optional[torch.Tensor] = None,
               cache_interval: int = 1, cfg_rescale: float = 0.0,
               negative_condition: Optional[torch.Tensor] = None,
               cfg_rescales: Optional[torch.Tensor] = None):
        """uint8 images [batch, image_size, image_size, 3] (and the final
        latent with return_latent). `generator` (on the pipeline's
        device) draws x_T unless init_noise is given, the per-step noise
        at eta > 0 (DDIM), and the MoE routing unless the config fixes it.

        sampler: 'ddim' or 'dpm++2m' (DPM-Solver++(2M), one UNet call per
        timestep). condition: class ids [batch] (a UNet with num_classes >
        0) or condition tokens [batch, T, D]; guidance_scale != 1, or
        per-sample guidance_scales [batch], applies classifier-free
        guidance against the null class or negative_condition [batch];
        cfg_rescale / per-sample cfg_rescales [batch]: guidance rescale
        phi (see `guide`). cache_interval > 1: DeepCache, the UNet's deep
        core recomputed every cache_interval steps and reused in between
        (an approximation; not with CFG)."""
        check_sampler(sampler)
        if negative_condition is not None:
            if condition is None or self.unet.cfg.num_classes <= 0:
                raise ValueError("negative_condition requires a class-conditional "
                                 "model and a condition")
            if guidance_scales is None and guidance_scale == 1.0:
                raise ValueError("negative_condition has no effect at guidance "
                                 "1.0: pass guidance_scale != 1 or guidance_scales")
        with span("pipeline.sample", batch=batch,
                  steps=num_steps if steps is None else len(steps)) as s:
            latent = image_size // self.decoder.cfg.downscale
            shape = (batch, latent, latent, self.unet.cfg.input_channels)
            denoise, step, use_cfg = self._denoise_fns(
                latent, num_steps, steps, film_cache, generator, condition,
                guidance_scale if guidance_scales is None else guidance_scales,
                cfg_rescale if cfg_rescales is None else cfg_rescales,
                negative_condition)
            if s is not None:
                s.attrs["guided"] = use_cfg
            if cache_interval > 1 and use_cfg:
                raise ValueError("cache_interval > 1 is not supported with "
                                 "classifier-free guidance")
            deep_cache = self._deep_cache(
                step, cache_interval,
                None if condition is None else condition.to(self.device))
            z = self._run(sampler, denoise, shape, eta, generator=generator,
                          num_steps=num_steps, steps=steps, init_noise=init_noise,
                          deep_cache=deep_cache)
            img = self._decode(z)
        return (img, z) if return_latent else img

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """uint8 images of latents z (the decoder, clamp, uint8), in a
        span pipeline.decode."""
        with span("pipeline.decode", rows=z.shape[0]):
            return to_uint8(self.decoder(z))

    @torch.no_grad()
    def img2img(self, image: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                strength: float = 0.6, num_steps: int = 20, eta: float = 0.0,
                sampler: str = "ddim", film_cache: bool = True,
                mask: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                guidance_scale: float = 1.0,
                fwd_noise: Optional[torch.Tensor] = None,
                guidance_scales: Optional[torch.Tensor] = None,
                cfg_rescale: float = 0.0,
                negative_condition: Optional[torch.Tensor] = None,
                cfg_rescales: Optional[torch.Tensor] = None,
                project_noise: Optional[torch.Tensor] = None,
                return_latent: bool = False):
        """Image-to-image and inpainting (SDEdit, arXiv:2108.01073), as the
        JAX package's img2img: encode `image` (float NHWC in [-1, 1],
        [B, S, S, 3]), diffuse it to t_start = strength (T - 1) with
        `fwd_noise` ([B, latent, latent, C], else drawn from `generator`),
        then sample over the sub-schedule img2img_steps(...) below it.
        strength in (0, 1]: 1 is a full generation. mask [B, H, W, 1] (1 =
        regenerate, 0 = keep; resized to the latent grid by resize_mask)
        keeps the known region, re-noised to each step's level and pasted
        exactly on the last (inpaint_projection; DDIM only); its
        per-step noise is `project_noise` ([steps, B, latent, latent, C])
        or drawn from `generator`. Guidance and routing as in `sample`.
        Returns uint8 images like `sample` (and the final latent with
        return_latent)."""
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        if mask is not None and sampler != "ddim":
            raise ValueError("inpainting (mask=) requires sampler='ddim'")
        if negative_condition is not None:
            if condition is None or self.unet.cfg.num_classes <= 0:
                raise ValueError("negative_condition requires a class-conditional "
                                 "model and a condition")
            if guidance_scales is None and guidance_scale == 1.0:
                raise ValueError("negative_condition has no effect at guidance "
                                 "1.0: pass guidance_scale != 1 or guidance_scales")
        check_sampler(sampler)
        with span("pipeline.sample", batch=image.shape[0]) as s:
            self._prepare()
            if self.encoder is None:
                raise ValueError("img2img needs a pipeline built with an encoder")
            sub_steps = img2img_steps(self.schedule.num_timesteps, strength, num_steps)
            dev = self.device
            z0 = self.encoder(image.to(dev)).float()
            b, latent = z0.shape[0], z0.shape[1]
            eps = (torch.randn(z0.shape, generator=generator, device=dev)
                   if fwd_noise is None else fwd_noise.to(dev, torch.float32))
            x_init = q_sample(self.schedule, z0, torch.full(
                (b,), sub_steps[-1], dtype=torch.int32, device=dev), eps)
            denoise, _, use_cfg = self._denoise_fns(
                latent, num_steps, sub_steps, film_cache, generator, condition,
                guidance_scale if guidance_scales is None else guidance_scales,
                cfg_rescale if cfg_rescales is None else cfg_rescales,
                negative_condition)
            if s is not None:
                s.attrs.update(steps=len(sub_steps), guided=use_cfg)
            project_fn = None
            if mask is not None:
                project_fn = inpaint_projection(
                    self.schedule, z0, resize_mask(mask.to(dev), latent))
            z = self._run(sampler, denoise, z0.shape, eta, project_fn, project_noise,
                          generator=generator, num_steps=num_steps, steps=sub_steps,
                          init_noise=x_init)
            img = self._decode(z)
        return (img, z) if return_latent else img


class DDPMPipeline(_Pipeline):
    """Pixel-space DDPM sampler, the torch counterpart of the JAX package's
    DDPMPipeline: DDIM (or DPM-Solver++(2M)) over a UNet with
    input_channels=3 directly on [B, S, S, 3] images, optionally with
    DeepCache, then clamp -> uint8; no VAE. The caller's UNet is not
    changed (cast copies and the FiLM memo as LDMPipeline's); each step
    draws its routing plan from the sampling generator unless the config
    fixes the experts."""

    def __init__(self, unet: UNet, ddpm_cfg: DDPMConfig = DDPMConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__((unet,), ddpm_cfg, dtype)

    @classmethod
    def random(cls, unet_cfg: UNetConfig = UNetConfig(input_channels=3),
               ddpm_cfg: DDPMConfig = DDPMConfig(),
               dtype: torch.dtype = torch.bfloat16, device="cuda",
               seed: int = 0) -> "DDPMPipeline":
        """A pipeline with seeded random weights (no checkpoint)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(UNet(unet_cfg, device=dev, generator=gen), ddpm_cfg, dtype)

    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None,
               batch: int = 1, image_size: int = 32, num_steps: int = 20,
               eta: float = 0.0, sampler: str = "ddim", film_cache: bool = True,
               steps: Optional[Sequence[int]] = None, cache_interval: int = 1,
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uint8 images [batch, image_size, image_size, input_channels].
        `generator` (on the pipeline's device) draws x_T unless init_noise
        is given, the per-step noise at eta > 0 (DDIM) and the MoE
        routing unless the config fixes it. cache_interval > 1: DeepCache
        (see LDMPipeline.sample)."""
        check_sampler(sampler)
        with span("pipeline.sample", batch=batch,
                  steps=num_steps if steps is None else len(steps), guided=False):
            shape = (batch, image_size, image_size, self.unet.cfg.input_channels)
            denoise, step, _ = self._denoise_fns(image_size, num_steps, steps,
                                                 film_cache, generator)
            x = self._run(sampler, denoise, shape, eta, generator=generator,
                          num_steps=num_steps, steps=steps, init_noise=init_noise,
                          deep_cache=self._deep_cache(step, cache_interval))
            return to_uint8(x)
