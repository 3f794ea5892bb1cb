"""Deterministic validation loss for diffusion training: the torch
counterparts of make_eval_step and Validator in
ldm_image_generator_tpu/train/eval.py.

    L_val = mean over t in linspace(1, T-1, num_t) of loss(model(x_t, t), target)

with one noise draw per batch, deterministic=True (no stochastic depth)
and one routing plan per grid point; the loss and target as ddpm_loss's
(L1 or L2, eps or v). A conditional UNet is evaluated without a
condition, as the JAX package's evaluator does. The noise and the plans
are drawn once, from the Validator's own seeded generator, so the metric
is the same in every evaluation, run and resume; tests inject JAX's.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ldm_image_generator_tpu_torch.diffusion.ddpm import (
    DiffusionSchedule,
    alpha_bar_at,
    q_sample,
)

# the seed of the Validator's draws (the JAX package's PRNGKey(1234))
SEED = 1234


def eval_timesteps(schedule: DiffusionSchedule, num_t: int) -> List[int]:
    """linspace(1, T - 1, num_t) truncated to ints, as jnp's astype(int32)."""
    return [int(v) for v in np.linspace(1, schedule.num_timesteps - 1, num_t,
                                        dtype=np.float32).astype(np.int32)]


def make_eval_step(unet: nn.Module, schedule: DiffusionSchedule, loss: str = "l1",
                   prediction: str = "eps", num_t: int = 8,
                   dtype: Optional[torch.dtype] = None) -> Callable:
    """Returns eval_step(params, x, eps, plans) -> 0-d tensor, the
    stratified validation loss of batch x under noise eps, with plans[i]
    the routing plan of grid point i (None entries: the UNet's fixed
    routing). params: None for the UNet's own parameters, or a
    {name: tensor} dict with its names (the EMA). Nothing here waits on
    the device."""
    ts = eval_timesteps(schedule, num_t)
    if prediction not in ("eps", "v"):
        raise ValueError(f"unknown prediction {prediction!r}")
    if loss not in ("l1", "l2"):
        raise ValueError(f"unknown loss {loss!r}")

    @torch.no_grad()
    def eval_step(params, x: torch.Tensor, eps: torch.Tensor,
                  plans: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        b = x.shape[0]
        xf, epsf = x.float(), eps.float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for t, plan in zip(ts, plans):
            t_vec = torch.full((b,), t, dtype=torch.long, device=x.device)
            x_t = q_sample(schedule, xf, t_vec, epsf)
            kwargs = dict(moe_plan=plan, deterministic=True, dtype=dtype)
            if params is None:
                out = unet(x_t, t_vec, **kwargs)
            else:
                out = torch.func.functional_call(unet, params, (x_t, t_vec), kwargs)
            out = out.float()
            if prediction == "eps":
                target = epsf
            else:
                ab = alpha_bar_at(schedule, t_vec)[0]
                target = torch.sqrt(ab) * epsf - torch.sqrt(1.0 - ab) * xf
            err = out - target
            total = total + (err.abs().mean() if loss == "l1" else (err * err).mean())
        return total / num_t

    return eval_step


class Validator:
    """Held-out validation for the trainer (--val-dir / --val-every): the
    stratified loss above on fixed batches of `dataset` (built once, in
    dataset order), for the parameters and, where the state has one, the
    EMA. draws: [(eps, plans)] per batch to use in place of the
    generator's (tests inject JAX's noise)."""

    def __init__(self, dataset, unet: nn.Module, schedule: DiffusionSchedule, *,
                 prediction: str = "eps", loss: str = "l1", batch: int = 1,
                 max_batches: int = 4, num_t: int = 8,
                 dtype: Optional[torch.dtype] = None,
                 draws: Optional[List[Tuple[torch.Tensor, list]]] = None):
        n = len(dataset)
        if n == 0:
            raise ValueError("validation dataset is empty")
        bs = min(batch, n)
        nb = max(1, min(max_batches, n // bs))
        device = unet.pairs.device
        self.batches = [
            torch.from_numpy(np.stack([np.asarray(dataset[i * bs + j], np.float32)
                                       for j in range(bs)])).to(device)
            for i in range(nb)]
        if draws is None:
            gen = torch.Generator(device=device).manual_seed(SEED)
            fixed = unet.cfg.fixed_expert_indices is not None
            draws = [(torch.randn(x.shape, generator=gen, device=device),
                      [None if fixed else unet.draw_plan(gen) for _ in range(num_t)])
                     for x in self.batches]
        if len(draws) != nb:
            raise ValueError(f"{len(draws)} draws for {nb} validation batches")
        self.draws = draws
        self._eval = make_eval_step(unet, schedule, loss=loss, prediction=prediction,
                                    num_t=num_t, dtype=dtype)

    def _avg(self, params) -> float:
        total = 0.0
        for x, (eps, plans) in zip(self.batches, self.draws):
            total += float(self._eval(params, x, eps, plans))
        return total / len(self.batches)

    def run(self, state) -> dict:
        out = {"val_loss": self._avg(None)}
        if getattr(state, "ema_params", None) is not None:
            out["val_loss_ema"] = self._avg(state.ema_params)
        return out
