"""Diffusion schedule, the training loss and the DDIM sampler, the torch
counterpart of ldm_image_generator_tpu/diffusion/ddpm.py.

The schedule is built in float64 with numpy and stored in float32, as the
JAX package does. The DDIM reverse process is a Python loop over the
step pairs (the JAX package's lax.scan); the per-step coefficients are
float32 host scalars, the latent stays on the device. The loss draws its
timesteps and noise from an explicit torch.Generator, or takes them
injected (the tests inject the JAX package's draws).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_image_generator_tpu_torch.config import DDPMConfig
from ldm_image_generator_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    beta: np.ndarray        # [T] float32
    alpha: np.ndarray       # [T] = 1 - beta
    alpha_bar: np.ndarray   # [T] cumulative product of alpha
    beta_tilde: np.ndarray  # [T] posterior variance (kept for parity)
    num_timesteps: int


def make_schedule(cfg: DDPMConfig = DDPMConfig()) -> DiffusionSchedule:
    t = cfg.num_timesteps
    beta = np.linspace(cfg.beta_min, cfg.beta_max, t, dtype=np.float64)
    alpha = 1.0 - beta
    alpha_bar = np.cumprod(alpha)
    if cfg.zero_terminal_snr:
        # rescale sqrt(alpha_bar) so the terminal step has zero signal
        # (Lin et al. 2023, arXiv:2305.08891, Alg. 1)
        if cfg.prediction != "v":
            raise ValueError(
                "zero_terminal_snr needs prediction='v': at alpha_bar==0 "
                "the eps parameterization cannot recover x0")
        sab = np.sqrt(alpha_bar)
        s0, sT = sab[0], sab[-1]
        alpha_bar = ((sab - sT) * (s0 / (s0 - sT))) ** 2
        alpha = np.empty_like(alpha_bar)
        alpha[0] = alpha_bar[0]
        alpha[1:] = alpha_bar[1:] / alpha_bar[:-1]
        beta = 1.0 - alpha
    beta_tilde = np.ones(t, dtype=np.float64)
    beta_tilde[1:] = (1.0 - alpha_bar[:-1]) / (1.0 - alpha_bar[1:]) * beta[1:]
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return DiffusionSchedule(beta=f32(beta), alpha=f32(alpha),
                             alpha_bar=f32(alpha_bar),
                             beta_tilde=f32(beta_tilde), num_timesteps=t)


def _bcast(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append singleton dims so a [B] vector broadcasts over [B, ...]."""
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def alpha_bar_at(schedule: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """float32 alpha_bar[t] on t's device."""
    ab = torch.from_numpy(schedule.alpha_bar).to(t.device)
    return ab[t.long()]


def q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             eps: torch.Tensor) -> torch.Tensor:
    """Forward process: sqrt(ab_t) x0 + sqrt(1 - ab_t) eps."""
    ab = _bcast(alpha_bar_at(schedule, t), x0.ndim).to(x0.dtype)
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps


def ddpm_loss(denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
              schedule: DiffusionSchedule, x: torch.Tensor,
              loss: str = "l1", prediction: str = "eps",
              min_snr_gamma: Optional[float] = None,
              generator: Optional[torch.Generator] = None,
              t: Optional[torch.Tensor] = None,
              eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noise-prediction loss (a scalar tensor). t [B] uniform in [1, T)
    and eps ~ N(0, 1) of x's shape are drawn from `generator` unless
    given. denoise_fn(x_t, t) -> model output in the parameterization
    `prediction` ('eps': target eps; 'v': sqrt(ab) eps - sqrt(1-ab) x0).
    min_snr_gamma: per-sample weight min(SNR, gamma) / SNR (eps) or
    min(SNR, gamma) / (SNR + 1) (v), arXiv:2303.09556; None: uniform."""
    b = x.shape[0]
    if t is None:
        t = torch.randint(1, schedule.num_timesteps, (b,), generator=generator,
                          device=x.device)
    if eps is None:
        eps = torch.randn(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype)
    t = t.to(x.device)
    x_t = q_sample(schedule, x, t, eps)
    out = denoise_fn(x_t, t).float()
    if prediction == "eps":
        target = eps.float()
    elif prediction == "v":
        ab = _bcast(alpha_bar_at(schedule, t), x.ndim)
        target = torch.sqrt(ab) * eps.float() - torch.sqrt(1.0 - ab) * x.float()
    else:
        raise ValueError(f"unknown prediction {prediction!r}")
    err = out - target
    w = None
    if min_snr_gamma is not None:
        ab_t = alpha_bar_at(schedule, t)
        snr = ab_t / torch.clamp(1.0 - ab_t, min=1e-12)
        denom = snr + 1.0 if prediction == "v" else torch.clamp(snr, min=1e-12)
        w = _bcast(torch.clamp(snr, max=float(min_snr_gamma)) / denom, x.ndim)
    if loss == "l1":
        e = err.abs()
    elif loss == "l2":
        e = err * err
    else:
        raise ValueError(f"unknown loss {loss!r}")
    return (e if w is None else w * e).mean()


def pred_to_eps_x0(pred: torch.Tensor, x_t: torch.Tensor, alpha_bar_t,
                   prediction: str = "eps") -> Tuple[torch.Tensor, torch.Tensor]:
    """(eps, x0) in fp32 from a model output in the given
    parameterization; alpha_bar_t is a float32 scalar."""
    ab = np.float32(alpha_bar_t)
    sa, sb = float(np.sqrt(ab)), float(np.sqrt(np.float32(1.0) - ab))
    xf = x_t.float()
    pred = pred.float()
    if prediction == "eps":
        return pred, (xf - sb * pred) / sa
    if prediction == "v":
        return sb * xf + sa * pred, sa * xf - sb * pred
    raise ValueError(f"unknown prediction {prediction!r}")


def film_schedule_ts(num_timesteps: int, num_steps: int,
                     steps=None) -> np.ndarray:
    """The ascending int32 timesteps a sampler run visits (the FiLM
    schedule's, DPM-Solver++'s): the linspace derived from num_steps, or
    the deduplicated explicit `steps`."""
    if steps is None:
        return np.linspace(0, num_timesteps - 1, num_steps).astype(np.int32)
    return np.asarray(sorted(set(int(s) for s in steps)), dtype=np.int32)


def ddim_step_pairs(num_timesteps: int, num_steps: int = 20,
                    steps: Optional[Sequence[int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(t, t_next) pairs in reverse order: linspace(0, T-1, num_steps)
    truncated to int (or the given list), t_next = [0] + steps[:-1]."""
    if steps is None:
        steps = np.linspace(0, num_timesteps - 1, num_steps).astype(np.int32)
    else:
        steps = np.asarray(list(steps), dtype=np.int32)
    steps_next = np.concatenate([[0], steps[:-1]]).astype(np.int32)
    return steps[::-1].copy(), steps_next[::-1].copy()


def model_step(denoise_fn, deep_cache, x, t: int, i: int, deep):
    """(model output, deep features) of sampler step i: denoise_fn, or
    with deep_cache (fresh_fn, cached_fn, interval) a fresh deep core
    every interval steps and the cached one in between."""
    if deep_cache is None:
        return denoise_fn(x, t), deep
    fresh_fn, cached_fn, interval = deep_cache
    if i % interval == 0:
        return fresh_fn(x, t)
    return cached_fn(x, t, deep), deep


def ddim_sample(
    denoise_fn: Callable[[torch.Tensor, int], torch.Tensor],
    schedule: DiffusionSchedule,
    x_shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    num_steps: int = 20,
    eta: float = 0.0,
    steps: Optional[Sequence[int]] = None,
    dtype=torch.float32,
    init_noise: Optional[torch.Tensor] = None,
    prediction: str = "eps",
    device="cuda",
    deep_cache=None,
    project_fn=None,
    project_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM reverse sampler. denoise_fn(x, t) -> model output for the
    integer timestep t (shared by the batch). x_T is `init_noise` or
    drawn from `generator`; the per-step noise (eta > 0) is drawn from
    `generator` too. Returns x0-space samples in `dtype`.
    deep_cache: (fresh_fn, cached_fn, interval) for DeepCache-style
    deep-feature reuse (models/unet.py deep/with_deep): fresh_fn(x, t)
    -> (pred, deep) recomputes the UNet's deep core, cached_fn(x, t,
    deep) -> pred reuses it; step i is fresh when i % interval == 0 (step
    0 always), and denoise_fn is not called.
    project_fn(x, t_next, final, noise) -> x is applied after every
    update (latent inpainting): a projection at the new noise level
    t_next, `final` True on the terminal t == 0 step (x already in x0
    space, noise None). Step i's noise ~ N(0, 1) of x_shape is
    project_noise[i] when given ([steps, *x_shape]), else drawn from
    `generator` after that step's model call and eta noise."""
    ts, ts_next = ddim_step_pairs(schedule.num_timesteps, num_steps, steps)
    ab = schedule.alpha_bar
    if init_noise is None:
        if generator is None:
            raise ValueError("ddim_sample needs init_noise or a generator")
        x = torch.randn(x_shape, generator=generator, device=device,
                        dtype=torch.float32).to(dtype)
    else:
        x = init_noise.to(device=device, dtype=dtype)
    one = np.float32(1.0)
    deep = None
    for i, (t, t_next) in enumerate(zip(ts.tolist(), ts_next.tolist())):
        with span("pipeline.step", i=i, t=t):
            pred, deep = model_step(denoise_fn, deep_cache, x, t, i, deep)
            eps_hat, x0 = pred_to_eps_x0(pred, x, ab[t], prediction)
            if t == 0:
                x = x0.to(dtype)
            else:
                a_t, a_n = ab[t], ab[t_next]
                sigma = np.float32(eta) * np.sqrt((one - a_n) / (one - a_t)) * np.sqrt(
                    np.maximum(one - a_t / a_n, np.float32(0.0)))
                c_eps = np.sqrt(np.maximum(one - a_n - sigma * sigma, np.float32(0.0)))
                x_new = float(np.sqrt(a_n)) * x0 + float(c_eps) * eps_hat
                if sigma != 0.0:
                    noise = torch.randn(x_shape, generator=generator, device=x.device,
                                        dtype=torch.float32)
                    x_new = x_new + float(sigma) * noise
                x = x_new.to(dtype)
            if project_fn is not None:
                noise = None
                if t != 0:
                    noise = (project_noise[i].to(x.device) if project_noise is not None
                             else torch.randn(x_shape, generator=generator,
                                              device=x.device, dtype=torch.float32))
                x = project_fn(x, int(t_next), t == 0, noise).to(dtype)
    return x
