"""The latent diffusion train step and its optimizer, the torch
counterparts of LDMTrainState, init_ema, make_ldm_train_step,
make_lr_schedule and make_optimizer in ldm_image_generator_tpu/train/
steps.py.

Parameters are fp32 (the UNet module holds them); the forward computes
in the dtype given to the step (bf16 on the card), each module casting
its parameters at use, so gradients arrive in fp32 through the casts.
The optimizer reproduces optax rather than torch.optim, in fp32 and in
optax's order of operations:

  - adamw: optax.adamw(lr) = scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    -> add_decayed_weights(1e-4) on every parameter (no mask; a parameter
    the loss does not reach still decays) -> scale by -lr;
  - grad_clip > 0 chains optax.clip_by_global_norm first (no epsilon:
    g * max_norm / ||g|| when ||g|| >= max_norm);
  - accumulate > 1 wraps it in optax.MultiSteps: the running mean of k
    gradients is applied on the k-th step, and the inner count (which
    the learning-rate schedule reads) advances only on updates;
  - schedules are read at the count before the update (warmup starts at
    lr 0; cosine decay_steps includes the warmup).

Only adamw is ported in this slice (the VAE's adafactor and the pixel
DDPM's radam come with those trainers). torch.optim.AdamW (fused or
not) is not used: it forms the bias corrections 1 - b**t in float64
where optax uses float32 (1 - 0.999 in float32 is off by 1.3e-5
relative), and leaves optax beyond the optimizer test's tolerance
(tests/test_torch_port_train.py, test_torch_adamw_leaves_optax).
Updates run in place with PyTorch's multi-tensor (_foreach) ops over
groups of CHUNK parameters:
a per-tensor loop over the default UNet's ~800 tensors made ~16,000
small launches per step and held the card idle; a group's temporaries
stay far below a second copy of the model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional

import numpy as np
import torch
from torch import nn

from ldm_image_generator_tpu_torch.diffusion.ddpm import DiffusionSchedule, ddpm_loss

F32 = np.float32
# parameters per group of multi-tensor ops
CHUNK = 64


def _chunks(*lists):
    """Zip of the lists, cut into groups of CHUNK: lists of lists."""
    n = len(lists[0])
    for i in range(0, n, CHUNK):
        yield [lst[i:i + CHUNK] for lst in lists]


@dataclasses.dataclass
class LDMTrainState:
    params: nn.Module            # the UNet, holding the fp32 master weights
    opt_state: Any
    step: int = 0
    # {parameter name: fp32 tensor}, or None when the EMA is off
    ema_params: Optional[dict] = None


def init_ema(params: nn.Module) -> dict:
    """A copy of every parameter to seed the EMA."""
    return {n: p.detach().clone() for n, p in params.named_parameters()}


def make_lr_schedule(learning_rate: float, schedule: str = "constant",
                     warmup_steps: int = 0, total_steps: int = 0):
    """A float (constant, no warmup) or count -> np.float32 learning rate,
    as optax computes it in float32: constant with an optional linear
    0 -> lr warmup, or warmup then cosine decay to 10% of lr at
    total_steps (which counts the warmup)."""
    if schedule == "constant":
        if warmup_steps <= 0:
            return learning_rate
        linear = _linear_schedule(0.0, learning_rate, warmup_steps)
        return lambda count: (linear(count) if count < warmup_steps
                              else F32(learning_rate))
    if schedule == "cosine":
        if total_steps <= 0:
            raise ValueError("cosine schedule needs total_steps > 0")
        if warmup_steps >= total_steps:
            raise ValueError(
                f"warmup_steps {warmup_steps} must be < total_steps "
                f"{total_steps} (decay_steps includes the warmup)")
        warm = max(warmup_steps, 1)
        linear = _linear_schedule(0.0, learning_rate, warm)
        end = 0.1 * learning_rate
        cosine = _cosine_schedule(learning_rate, total_steps - warm,
                                  end / learning_rate)
        return lambda count: linear(count) if count < warm else cosine(count - warm)
    raise ValueError(f"unknown lr schedule {schedule!r}")


def _linear_schedule(init: float, end: float, steps: int):
    def schedule(count: int):
        frac = F32(1) - F32(min(max(count, 0), steps)) / F32(steps)
        return F32(init - end) * frac + F32(end)
    return schedule


def _cosine_schedule(peak: float, decay_steps: int, alpha: float):
    def schedule(count: int):
        c = F32(min(count, decay_steps))
        cos = F32(0.5) * (F32(1) + np.cos(F32(math.pi) * c / F32(decay_steps)))
        return F32(peak) * (F32(1 - alpha) * cos + F32(alpha))
    return schedule


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass
class MultiStepsState:
    mini_step: int
    gradient_step: int
    inner_opt_state: AdamWState
    acc_grads: List[torch.Tensor]


class AdamW:
    """[clip_by_global_norm ->] optax.adamw with its defaults, applied in
    place."""

    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, learning_rate, grad_clip: float = 0.0):
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        z = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamWState(count=0, mu=z(), nu=z())

    def lr(self, count: int):
        lr = self.learning_rate
        return F32(lr(count) if callable(lr) else lr)

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: AdamWState) -> AdamWState:
        """params += the update for grads; returns the new state."""
        if self.grad_clip > 0.0:
            g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            keep = g_norm < self.grad_clip
            grads = [torch.where(keep, g, (g / g_norm) * self.grad_clip)
                     for g in grads]
        count = state.count + 1
        bc1 = float(F32(1) - F32(self.b1) ** F32(count))
        bc2 = float(F32(1) - F32(self.b2) ** F32(count))
        neg_lr = float(-self.lr(state.count))
        b1, b2 = self.b1, self.b2
        for p, g, mu, nu in _chunks(params, grads, state.mu, state.nu):
            g = [t.float() for t in g]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, g2)
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p; p += -lr u
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(u, neg_lr)
            torch._foreach_add_(p, u)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k) with the gradient mean."""

    def __init__(self, inner: AdamW, every_k: int):
        self.inner = inner
        self.every_k = every_k

    def init(self, params: List[torch.Tensor]) -> MultiStepsState:
        return MultiStepsState(
            mini_step=0, gradient_step=0, inner_opt_state=self.inner.init(params),
            acc_grads=[torch.zeros_like(p, dtype=torch.float32) for p in params])

    @torch.no_grad()
    def apply(self, params, grads, state: MultiStepsState) -> MultiStepsState:
        n = state.mini_step
        for acc, g in _chunks(state.acc_grads, grads):
            d = torch._foreach_sub([t.float() for t in g], acc)
            torch._foreach_div_(d, n + 1)
            torch._foreach_add_(acc, d)
        inner, step = state.inner_opt_state, state.gradient_step
        if n == self.every_k - 1:
            inner = self.inner.apply(params, state.acc_grads, inner)
            for acc in state.acc_grads:
                acc.zero_()
            step += 1
        return MultiStepsState(mini_step=(n + 1) % self.every_k,
                               gradient_step=step, inner_opt_state=inner,
                               acc_grads=state.acc_grads)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], step: int,
               decay: float) -> None:
    """ema = d * ema + (1 - d) * params in place, d = min(decay,
    (1 + step) / (10 + step)) in float32 at the step count before the
    increment, as the JAX train step computes it (one lerp per tensor)."""
    step_f = F32(step)
    d = min(F32(decay), (F32(1) + step_f) / (F32(10) + step_f))
    for e, p in _chunks(ema, params):
        torch._foreach_lerp_(e, p, float(F32(1) - d))


def make_optimizer(name: str, learning_rate: float = 1e-4,
                   accumulate: int = 1, grad_clip: float = 0.0,
                   lr_schedule: str = "constant", warmup_steps: int = 0,
                   total_steps: int = 0):
    """adamw [with clipping, an LR schedule and MultiSteps accumulation],
    each off by default as in the JAX package."""
    if name != "adamw":
        raise ValueError(f"optimizer {name!r} is not ported (adamw only; "
                         "adafactor and radam come with the VAE and DDPM "
                         "trainers)")
    lr = make_lr_schedule(learning_rate, lr_schedule, warmup_steps, total_steps)
    tx = AdamW(lr, grad_clip=grad_clip)
    return MultiSteps(tx, accumulate) if accumulate > 1 else tx


def make_ldm_train_step(unet: nn.Module, schedule: DiffusionSchedule, tx,
                        loss: str = "l1", stochastic_depth: bool = True,
                        prediction: str = "eps",
                        ema_decay: Optional[float] = None,
                        min_snr_gamma: Optional[float] = None,
                        dtype: Optional[torch.dtype] = None) -> Callable:
    """Returns step(state, latents, generator=None, t=None, eps=None,
    moe_plan=None, sd_gates=None) -> (state, {"loss": scalar tensor}).

    state.params must be `unet`. The generator draws t, the noise, the routing
    plan and the stochastic-depth gates, in that order, unless given. The
    loss is value-and-grad of ddpm_loss; every parameter then holds a
    gradient tensor (zeros where the loss does not reach it, as jax.grad
    gives), the optimizer updates in place, and the EMA follows with
    d = min(ema_decay, (1 + step) / (10 + step)) at the step count before
    the increment. Nothing here waits on the device."""

    def step(state: LDMTrainState, x: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
             moe_plan=None, sd_gates=None):
        if state.params is not unet:
            raise ValueError("state.params is not the UNet this step was made for")
        x = x.float()
        model = unet
        params = list(model.parameters())
        for p in params:
            p.grad = None

        def denoise(x_t, tt):
            return model(x_t, tt, moe_plan=moe_plan, generator=generator,
                         sd_gates=sd_gates, deterministic=not stochastic_depth,
                         dtype=dtype).float()

        loss_val = ddpm_loss(denoise, schedule, x, loss=loss,
                             prediction=prediction,
                             min_snr_gamma=min_snr_gamma,
                             generator=generator, t=t, eps=eps)
        loss_val.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt_state = tx.apply(params, [p.grad for p in params], state.opt_state)
        ema = state.ema_params
        if ema_decay is not None and ema is not None:
            names = [n for n, _ in model.named_parameters()]
            ema_update([ema[n] for n in names], params, state.step, ema_decay)
        new_state = dataclasses.replace(state, opt_state=opt_state,
                                        step=state.step + 1)
        return new_state, {"loss": loss_val.detach()}

    return step
