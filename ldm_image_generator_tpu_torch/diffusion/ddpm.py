"""Diffusion schedule and the DDIM sampler, the torch counterpart of
ldm_image_generator_tpu/diffusion/ddpm.py.

The schedule is built in float64 with numpy and stored in float32, as the
JAX package does. The DDIM reverse process is a Python loop over the
step pairs (the JAX package's lax.scan); the per-step coefficients are
float32 host scalars, the latent stays on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_image_generator_tpu_torch.config import DDPMConfig


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
) -> torch.Tensor:
    """DDIM reverse sampler. denoise_fn(x, t) -> model output for the
    integer timestep t (shared by the batch). x_T is `init_noise` or
    drawn from `generator`; the per-step noise (eta > 0) is drawn from
    `generator` too. Returns x0-space samples in `dtype`."""
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
    for t, t_next in zip(ts.tolist(), ts_next.tolist()):
        pred = denoise_fn(x, t)
        eps_hat, x0 = pred_to_eps_x0(pred, x, ab[t], prediction)
        if t == 0:
            x = x0.to(dtype)
            continue
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
    return x
