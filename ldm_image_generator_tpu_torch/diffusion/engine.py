"""Object-style DDPM wrapper with the reference's API, the torch
counterpart of ldm_image_generator_tpu/diffusion/engine.py.

The functional core is diffusion/ddpm.py (schedule, loss, DDIM); this
wrapper packages it with a model the way the reference's
``DDPM(model).calculate_loss(x)`` / ``.sample(shape)`` surface does. The
model (a port UNet) holds its own weights, so there is no params
argument; randomness comes from an explicit torch.Generator. The CFG
bounds lambda_max / lambda_min are stored for parity (the reference never
uses them).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ldm_image_generator_tpu_torch.config import DDPMConfig
from ldm_image_generator_tpu_torch.diffusion.ddpm import (
    ddim_sample,
    ddpm_loss,
    make_schedule,
)


class DDPM:
    """model: a UNet-like module called as model(x, t, condition,
    moe_plan=..., generator=..., deterministic=...) (the port's UNet)."""

    def __init__(self, model, beta_min: float = 1e-4, beta_max: float = 0.02,
                 num_timesteps: int = 1000, loss_function: str = "l1",
                 lambda_max: float = 20.0, lambda_min: float = -20.0,
                 prediction: str = "eps", zero_terminal_snr: bool = False):
        self.model = model
        self.cfg = DDPMConfig(beta_min=beta_min, beta_max=beta_max,
                              num_timesteps=num_timesteps, loss=loss_function,
                              lambda_max=lambda_max, lambda_min=lambda_min,
                              prediction=prediction,
                              zero_terminal_snr=zero_terminal_snr)
        self.schedule = make_schedule(self.cfg)
        self.num_timesteps = num_timesteps

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def calculate_loss(self, x: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       condition=None, train: bool = True,
                       t: Optional[torch.Tensor] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference's DDPM.calculate_loss: ddpm_loss of the model in
        this wrapper's loss and prediction. The generator draws t, the
        noise (unless given), then the routing plan and, with train, the
        stochastic-depth gates."""
        def denoise(x_t, tt):
            return self.model(x_t, tt, condition, generator=generator,
                              deterministic=not train).float()

        return ddpm_loss(denoise, self.schedule, x, loss=self.cfg.loss,
                         prediction=self.cfg.prediction, generator=generator,
                         t=t, eps=eps)

    @torch.no_grad()
    def sample(self, x_shape: Tuple[int, ...] = (1, 64, 64, 3), condition=None,
               seed: Optional[int] = None, num_steps: int = 20,
               schedule: Union[str, Sequence[int]] = "linear", eta: float = 0.0,
               guidance_scale: float = 1.0, use_autocast: Optional[bool] = None,
               generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference's DDPM.sample: fp32 x0-space samples of NHWC
        x_shape over a linear or an explicit step schedule, eta-DDIM.
        `seed` seeds a torch.Generator on the model's device (0 when None)
        unless `generator` is given; it draws x_T (unless init_noise), the
        eta noise and one routing plan per step.

        guidance_scale != 1 with a condition applies classifier-free
        guidance, eps_u + s (eps_c - eps_u), the unconditional branch the
        model without a condition; both branches of a step take one
        routing plan, as the JAX package passes one key to both.
        use_autocast is accepted for call-site compatibility and ignored:
        the compute precision is the model's."""
        del use_autocast
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(
                0 if seed is None else seed)
        steps = None
        if isinstance(schedule, str):
            if schedule != "linear":
                raise NotImplementedError(f"schedule {schedule!r}")
        else:
            steps = tuple(int(s) for s in schedule)
        if condition is not None and isinstance(condition, torch.Tensor):
            condition = condition.to(dev)
        use_cfg = condition is not None and guidance_scale != 1.0
        fixed = self.model.cfg.fixed_expert_indices is not None

        def denoise(x, t):
            plan = None if fixed else self.model.draw_plan(generator)
            t_vec = torch.full((1,), t, dtype=torch.int32, device=dev)
            call = lambda cond: self.model(x, t_vec, cond, moe_plan=plan).float()
            if not use_cfg:
                return call(condition)
            eps_c, eps_u = call(condition), call(None)
            return eps_u + guidance_scale * (eps_c - eps_u)

        return ddim_sample(denoise, self.schedule, tuple(x_shape),
                           generator=generator, num_steps=num_steps, eta=eta,
                           steps=steps, init_noise=init_noise,
                           prediction=self.cfg.prediction, device=dev)
