"""DPM-Solver++(2M) sampler (Lu et al. 2022, arXiv:2211.01095), the
torch counterpart of ldm_image_generator_tpu/diffusion/dpm_solver.py.

x0-parameterized second-order multistep solver:
    alpha_t = sqrt(alpha_bar_t), sigma_t = sqrt(1 - alpha_bar_t),
    lambda_t = log(alpha_t) - log(sigma_t)
    h_i = lambda_{t_i} - lambda_{t_{i-1}}
    first step (1st order):   D = x0
    later steps (2M):         r = h_{i-1} / h_i
                              D = (1 + 1/(2r)) x0_i - 1/(2r) x0_{i-1}
    x_{t_i} = (sigma_{t_i} / sigma_{t_{i-1}}) x - alpha_{t_i} (e^{-h_i} - 1) D
and the x0 prediction at the last timestep is the result. A Python loop
over the steps (the JAX package's lax.scan); alpha, sigma, lambda and
every per-step coefficient are float32 host scalars computed from the
float32 alpha_bar, as the JAX package computes them in float32 (float64
coefficients move the latents past fp32 tolerance over the steps).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_image_generator_tpu_torch.diffusion.ddpm import (
    DiffusionSchedule,
    film_schedule_ts,
    model_step,
    pred_to_eps_x0,
)
from ldm_image_generator_tpu_torch.utils.profiling import span


def dpm_solver_sample(
    denoise_fn: Callable[[torch.Tensor, int], torch.Tensor],
    schedule: DiffusionSchedule,
    x_shape: Tuple[int, ...],
    generator: Optional[torch.Generator] = None,
    num_steps: int = 10,
    steps: Optional[Sequence[int]] = None,
    dtype=torch.float32,
    prediction: str = "eps",
    init_noise: Optional[torch.Tensor] = None,
    device="cuda",
    deep_cache=None,
) -> torch.Tensor:
    """DPM-Solver++(2M). denoise_fn(x, t) -> model output in the
    `prediction` parameterization for the integer timestep t (shared by
    the batch); x_T is `init_noise` or drawn from `generator`. One model
    call per timestep. deep_cache: (fresh_fn, cached_fn, interval), as
    ddim_sample's. Returns x0-space samples in `dtype`."""
    # high noise -> low noise
    ts = film_schedule_ts(schedule.num_timesteps, num_steps, steps)[::-1].tolist()
    ab = schedule.alpha_bar.astype(np.float32)
    alpha = np.sqrt(ab)
    sigma = np.sqrt(np.float32(1.0) - ab)
    lam = np.log(alpha) - np.log(sigma)
    if init_noise is None:
        if generator is None:
            raise ValueError("dpm_solver_sample needs init_noise or a generator")
        x = torch.randn(x_shape, generator=generator, device=device,
                        dtype=torch.float32)
    else:
        x = init_noise.to(device=device, dtype=torch.float32)
    deep = None

    def x0_of(x, t, i):
        nonlocal deep
        pred, deep = model_step(denoise_fn, deep_cache, x.to(dtype), t, i, deep)
        return pred_to_eps_x0(pred, x, ab[t], prediction)[1]

    def update(x, t_prev, t_cur, d):
        h = lam[t_cur] - lam[t_prev]
        c_x = sigma[t_cur] / sigma[t_prev]
        c_d = alpha[t_cur] * (np.exp(-h) - np.float32(1.0))
        return float(c_x) * x - float(c_d) * d

    # one span pipeline.step per timestep: its model call and the update
    # that follows it
    with span("pipeline.step", i=0, t=ts[0]):
        x0_prev = x0_of(x, ts[0], 0)
        if len(ts) > 1:
            x = update(x, ts[0], ts[1], x0_prev)  # first step: first order
    if len(ts) == 1:
        return x0_prev.to(dtype)
    h_prev = lam[ts[1]] - lam[ts[0]]
    one, two = np.float32(1.0), np.float32(2.0)
    for i in range(len(ts) - 2):
        t_cur, t_next = ts[i + 1], ts[i + 2]
        with span("pipeline.step", i=i + 1, t=t_cur):
            x0_cur = x0_of(x, t_cur, i + 1)
            h = lam[t_next] - lam[t_cur]
            r = h_prev / h
            c_cur, c_prev = one + one / (two * r), one / (two * r)
            d = float(c_cur) * x0_cur - float(c_prev) * x0_prev
            x = update(x, t_cur, t_next, d)
        x0_prev, h_prev = x0_cur, h
    with span("pipeline.step", i=len(ts) - 1, t=ts[-1]):
        return x0_of(x, ts[-1], len(ts) - 1).to(dtype)
