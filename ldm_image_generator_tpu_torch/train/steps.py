"""The train steps and their optimizers, the torch counterparts of
VAETrainState, LDMTrainState, init_ema, random_crop_batch,
make_vae_train_step, make_ldm_train_step, make_lr_schedule and
make_optimizer in ldm_image_generator_tpu/train/steps.py.

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
    lr 0; cosine decay_steps includes the warmup);
  - adafactor: optax.adafactor(learning_rate=relative_step), optax
    0.2.6's chain scale_by_factored_rms(decay_rate=0.8, eps=1e-30,
    min_dim_size_to_factor=128) -> clip_by_block_rms(1.0) -> scale by
    the relative step -> scale by max(rms(param), 1e-3) of the parameter
    before the update -> scale by -1 (see Adafactor). torch.optim.Adafactor
    is another algorithm (no block clipping, its own decay and epsilons);
  - radam (the pixel DDPM's): optax.radam(lr) = scale_by_radam(b1=0.9,
    b2=0.999, eps=1e-8, eps_root=0, threshold=5.0) -> scale by -lr (see
    RAdam); no weight decay.

torch.optim.AdamW and torch.optim.RAdam (fused or not) are not used:
they form the bias corrections 1 - b**t (and RAdam's rho) in float64
where optax uses float32 (1 - 0.999 in float32 is off by 1.3e-5
relative), torch's RAdam also adds eps before scaling by sqrt(1 - b2**t)
and rectifies at rho > 5 where optax takes rho >= 5, and both leave
optax beyond the optimizer test's tolerance (tests/test_torch_port_train.py,
test_torch_adamw_leaves_optax, test_torch_radam_leaves_optax).

Updates run in place with PyTorch's multi-tensor (_foreach) ops over
groups of CHUNK parameters (Adafactor's factored statistics, one mean
per axis, per tensor):
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
import torch.nn.functional as F
from torch import nn

from ldm_image_generator_tpu_torch.diffusion.ddpm import DiffusionSchedule, ddpm_loss
from ldm_image_generator_tpu_torch.models.vae import vae_loss

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


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sq_sum: Optional[torch.Tensor] = None) -> list:
    """optax.clip_by_global_norm: g * max_norm / ||g|| when ||g|| >=
    max_norm (no epsilon), with ||g|| over every tensor (sq_sum: its
    square, given where the gradients are slices of whole ones)."""
    dev = grads[0].device  # a pipelined UNet's parameters span devices
    if sq_sum is None:
        sq_sum = sum(g.float().square().sum().to(dev) for g in grads)
    g_norm = torch.sqrt(sq_sum)
    keep = g_norm < max_norm
    return [torch.where(keep.to(g.device), g, (g / g_norm.to(g.device)) * max_norm)
            for g in grads]


def _update_moments(g, mu, nu, b1: float, b2: float) -> None:
    """mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu, in place, in
    fp32 (optax's update_moment and update_moment_per_elem_norm)."""
    g = [t.float() for t in g]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    g2 = torch._foreach_mul(g, g)
    torch._foreach_mul_(g2, 1 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, g2)


class AdamW:
    """[clip_by_global_norm ->] optax.adamw with its defaults, applied in
    place. With zero1 (a parallel.mesh.Zero1 over the parameters) the
    state holds only this rank's slice of each split moment, the update
    reads this rank's slice of each (all-reduced, clipped) gradient and
    writes its slice of each parameter, and the parameters are then
    all-gathered: elementwise the same update as without it. With shards
    (a parallel.mesh.ParamShards: the parameters are slices over a model
    axis) the update is elementwise on the slices, and the clip's norm
    sums the slices' squares over the model group."""

    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 1e-4

    def __init__(self, learning_rate, grad_clip: float = 0.0, zero1=None, shards=None):
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.zero1 = zero1
        self.shards = shards

    def _local(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's slices of tensors shaped as the parameters."""
        if self.zero1 is None:
            return list(tensors)
        return [self.zero1.local(t, i) for i, t in enumerate(tensors)]

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        z = lambda: [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                     for t in self._local(params)]
        return AdamWState(count=0, mu=z(), nu=z())

    def lr(self, count: int):
        lr = self.learning_rate
        return F32(lr(count) if callable(lr) else lr)

    def full_state(self, state: AdamWState) -> AdamWState:
        """The state as one process holds it (a ZeRO-1 state's moments
        all-gathered, so every rank must call this), for a checkpoint."""
        if self.zero1 is None:
            return state
        return AdamWState(count=state.count, mu=self.zero1.gathered(state.mu),
                          nu=self.zero1.gathered(state.nu))

    def local_tree(self, tree: dict) -> dict:
        """A checkpoint's state tree (full_state's form) cut to this
        rank's slices."""
        if self.zero1 is None:
            return tree
        return dict(tree, mu=self._local(tree["mu"]), nu=self._local(tree["nu"]))

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: AdamWState) -> AdamWState:
        """params += the update for grads; returns the new state."""
        if self.grad_clip > 0.0:
            sq = None if self.shards is None else self.shards.sq_sum(params, grads)
            grads = clip_by_global_norm(grads, self.grad_clip, sq)
        count = state.count + 1
        self._update(self._local(params), self._local(grads), state, count)
        if self.zero1 is not None:
            self.zero1.gather(params)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)

    def _update(self, params, grads, state: AdamWState, count: int) -> None:
        bc1 = float(F32(1) - F32(self.b1) ** F32(count))
        bc2 = float(F32(1) - F32(self.b2) ** F32(count))
        neg_lr = float(-self.lr(state.count))
        for p, g, mu, nu in _chunks(params, grads, state.mu, state.nu):
            _update_moments(g, mu, nu, self.b1, self.b2)
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p; p += -lr u
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(u, neg_lr)
            torch._foreach_add_(p, u)


class RAdam(AdamW):
    """[clip_by_global_norm ->] optax.radam with its defaults, applied in
    place (the state is AdamW's: count, mu, nu; ZeRO-1 as AdamW's). With
    t the count after the increment, every scalar in float32 as optax
    forms it in a jitted step (b2**t as XLA's pow, which numpy's float32
    power equals):

      rho_inf = 2 / (1 - b2) - 1
      rho = rho_inf - 2 t b2**t / (1 - b2**t)
      m = mu / (1 - b1**t); v = nu / (1 - b2**t)
      u = r m / (sqrt(v) + eps) when rho >= threshold, else m, with
      r = sqrt((rho - 4)(rho - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2) rho))
      p += -lr u

    The first rectified step is t = 6 (rho 5.97). (Outside jit optax
    takes b2**t for a concrete t by repeated products: rho 5.95 there.)"""

    threshold = 5.0

    def rectifier(self, count: int):
        """r of the count after the increment, or None below the
        threshold (the update is then the bias-corrected momentum)."""
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = F32(self.b2) ** F32(count)
        ro = F32(ro_inf) - F32(2 * count) * b2t / (F32(1) - b2t)
        if not ro >= F32(self.threshold):
            return None
        return np.sqrt((ro - F32(4)) * (ro - F32(2)) * F32(ro_inf)
                       / (F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))

    def _update(self, params, grads, state: AdamWState, count: int) -> None:
        bc1 = float(F32(1) - F32(self.b1) ** F32(count))
        bc2 = float(F32(1) - F32(self.b2) ** F32(count))
        r = self.rectifier(count)
        neg_lr = float(-self.lr(state.count))
        for p, g, mu, nu in _chunks(params, grads, state.mu, state.nu):
            _update_moments(g, mu, nu, self.b1, self.b2)
            u = torch._foreach_div(mu, bc1)
            if r is not None:
                den = torch._foreach_div(nu, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, self.eps)
                torch._foreach_mul_(u, float(r))
                torch._foreach_div_(u, den)
            torch._foreach_mul_(u, neg_lr)
            torch._foreach_add_(p, u)


def relative_step(count: int) -> np.float32:
    """min(1e-2, 1 / sqrt(count + 1)) in float32, the step size the JAX
    package gives optax.adafactor. Correctly rounded; XLA's CPU rsqrt is
    within one ulp of it (equal up to count 9999, where the min holds)."""
    return min(F32(1e-2), F32(1.0 / math.sqrt(count + 1.0)))


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """(d1, d0), the second largest and the largest axis as np.argsort
    orders them (ties fall as there), when the second largest has at
    least min_dim_size_to_factor entries; else None (optax's
    _factored_dims)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass
class AdafactorState:
    count: int
    # per parameter: the row and column statistics of a factored one, or
    # the full second moment v of the others (None where unused)
    v_row: List[Optional[torch.Tensor]]
    v_col: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]


class Adafactor:
    """[clip_by_global_norm ->] optax.adafactor(learning_rate=relative_step)
    with its defaults, applied in place, in fp32 and in optax's order:

      decay = 1 - (count + 1)^-0.8 (float32; count before the update)
      g2 = g^2 + eps
      factored (factored_dims (d1, d0)):
        v_row = decay v_row + (1 - decay) mean(g2, d0)
        v_col = decay v_col + (1 - decay) mean(g2, d1)
        u = g (v_row / mean(v_row over d1))^-1/2 v_col^-1/2
      else: v = decay v + (1 - decay) g2; u = g v^-1/2
      u /= max(1, rms(u) / 1.0)                        (clip_by_block_rms)
      p += -relative_step(count) max(rms(p), 1e-3) u   (p before the update)

    The three scalings of each tensor are folded into one factor. With
    shards (a parallel.mesh.ParamShards) a split parameter's statistics
    are its whole tensor's: the factoring reads the whole shape, and a
    mean over the split dimension and the two RMS are summed over the
    model group."""

    decay_rate, eps, min_dim_size_to_factor = 0.8, 1e-30, 128
    clipping_threshold, min_scale = 1.0, 1e-3

    def __init__(self, grad_clip: float = 0.0, shards=None):
        self.grad_clip = grad_clip
        self.shards = shards

    def _split(self, p: torch.Tensor) -> Optional[int]:
        return None if self.shards is None else self.shards.split_dim.get(id(p))

    def _whole_shape(self, p: torch.Tensor) -> tuple:
        shape, d = list(p.shape), self._split(p)
        if d is not None:
            shape[d] *= self.shards.world
        return tuple(shape)

    def _mean(self, t: torch.Tensor, dim: int, n: int, split: bool,
              keepdim: bool = False) -> torch.Tensor:
        """t's mean over dim (n entries in the whole tensor), summed over
        the model group where dim is the split one."""
        if not split:
            return t.mean(dim, keepdim=keepdim)
        s = t.sum(dim, keepdim=keepdim)
        torch.distributed.all_reduce(s, group=self.shards.group)
        return s / n

    def full_state(self, state: AdafactorState) -> AdafactorState:
        return state

    def local_tree(self, tree: dict) -> dict:
        return tree

    def _dims(self, p: torch.Tensor):
        return factored_dims(self._whole_shape(p), self.min_dim_size_to_factor)

    def init(self, params: List[torch.Tensor]) -> AdafactorState:
        v_row, v_col, v = [], [], []
        for p in params:
            dims = self._dims(p)
            zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                              device=p.device)
            if dims is None:
                v_row.append(None)
                v_col.append(None)
                v.append(zeros(p.shape))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                v_row.append(zeros(shape[:d0] + shape[d0 + 1:]))
                v_col.append(zeros(shape[:d1] + shape[d1 + 1:]))
                v.append(None)
        return AdafactorState(count=0, v_row=v_row, v_col=v_col, v=v)

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: AdafactorState) -> AdafactorState:
        """params += the update for grads; returns the new state."""
        if self.grad_clip > 0.0:
            sq = None if self.shards is None else self.shards.sq_sum(params, grads)
            grads = clip_by_global_norm(grads, self.grad_clip, sq)
        decay = F32(1) - F32(state.count + 1) ** F32(-self.decay_rate)
        keep, fresh = float(decay), float(F32(1) - decay)
        updates: List[Optional[torch.Tensor]] = [None] * len(params)
        plain = [i for i, v in enumerate(state.v) if v is not None]
        for idx, in _chunks(plain):
            g = [grads[i].float() for i in idx]
            v = [state.v[i] for i in idx]
            g2 = torch._foreach_mul(g, g)
            torch._foreach_add_(g2, self.eps)
            torch._foreach_mul_(v, keep)
            torch._foreach_mul_(g2, fresh)
            torch._foreach_add_(v, g2)
            u = torch._foreach_rsqrt(v)
            torch._foreach_mul_(u, g)
            for i, t in zip(idx, u):
                updates[i] = t
        for i, v_row in enumerate(state.v_row):
            if v_row is None:
                continue
            d1, d0 = self._dims(params[i])
            whole, split = self._whole_shape(params[i]), self._split(params[i])
            g = grads[i].float()
            g2 = g * g + self.eps
            v_col = state.v_col[i]
            v_row.mul_(keep).add_(self._mean(g2, d0, whole[d0], split == d0) * fresh)
            v_col.mul_(keep).add_(self._mean(g2, d1, whole[d1], split == d1) * fresh)
            row_mean = self._mean(v_row, d1 - 1 if d1 > d0 else d1, whole[d1],
                                  split == d1, keepdim=True)
            updates[i] = (g * (v_row / row_mean).rsqrt().unsqueeze(d0)
                          * v_col.rsqrt().unsqueeze(d1))
        neg_lr = -float(relative_step(state.count))
        for p, u in _chunks(params, updates):
            size = torch.tensor([math.prod(self._whole_shape(t)) for t in p],
                                dtype=torch.float32, device=p[0].device)
            norm_u = torch.stack(torch._foreach_norm(u))
            norm_p = torch.stack(torch._foreach_norm(p))
            split = [j for j, t in enumerate(p) if self._split(t) is not None]
            if split:  # whole tensors' norms: the slices' squares summed
                sq = torch.stack([norm_u[split], norm_p[split]]).square()
                torch.distributed.all_reduce(sq, group=self.shards.group)
                norm_u[split], norm_p[split] = sq.sqrt().unbind()
            rms_u = norm_u / size.sqrt()
            rms_p = norm_p / size.sqrt()
            scale = (neg_lr / (rms_u / self.clipping_threshold).clamp_min(1.0)
                     * rms_p.clamp_min(self.min_scale))
            torch._foreach_mul_(u, list(scale.unbind()))
            torch._foreach_add_(p, u)
        return dataclasses.replace(state, count=state.count + 1)


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k) with the gradient mean."""

    def __init__(self, inner, every_k: int):
        self.inner = inner
        self.every_k = every_k

    def init(self, params: List[torch.Tensor]) -> MultiStepsState:
        return MultiStepsState(
            mini_step=0, gradient_step=0, inner_opt_state=self.inner.init(params),
            acc_grads=[torch.zeros_like(p, dtype=torch.float32) for p in params])

    def full_state(self, state: MultiStepsState) -> MultiStepsState:
        """The inner state's full_state (the gradient sums stay whole)."""
        return dataclasses.replace(
            state, inner_opt_state=self.inner.full_state(state.inner_opt_state))

    def local_tree(self, tree: dict) -> dict:
        return dict(tree, inner_opt_state=self.inner.local_tree(tree["inner_opt_state"]))

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
                   total_steps: int = 0, zero1=None, shards=None):
    """adamw or radam [with an LR schedule], or adafactor (its own
    relative step; learning_rate and the schedule are not read), each
    with clipping and MultiSteps accumulation, off by default as in the
    JAX package. zero1: a parallel.mesh.Zero1 splitting adamw's or
    radam's moments over a data-parallel group (the gradient sums of
    MultiSteps stay whole). shards: the parallel.mesh.ParamShards the
    parameters are slices of (tensor or expert parallelism)."""
    if name == "adafactor":
        if zero1 is not None:
            raise ValueError("ZeRO-1 splits adamw's and radam's moments only")
        tx = Adafactor(grad_clip=grad_clip, shards=shards)
    elif name in ("adamw", "radam"):
        lr = make_lr_schedule(learning_rate, lr_schedule, warmup_steps, total_steps)
        tx = (AdamW if name == "adamw" else RAdam)(lr, grad_clip=grad_clip,
                                                   zero1=zero1, shards=shards)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return MultiSteps(tx, accumulate) if accumulate > 1 else tx


def make_ldm_train_step(unet: nn.Module, schedule: DiffusionSchedule, tx,
                        loss: str = "l1", stochastic_depth: bool = True,
                        prediction: str = "eps",
                        ema_decay: Optional[float] = None,
                        min_snr_gamma: Optional[float] = None,
                        dtype: Optional[torch.dtype] = None,
                        num_classes: int = 0,
                        cond_drop: float = 0.1,
                        reduce_grads=None,
                        apply_fn: Optional[Callable] = None) -> Callable:
    """Returns step(state, latents, generator=None, t=None, eps=None,
    moe_plan=None, sd_gates=None, labels=None, cond=None) -> (state,
    {"loss": scalar tensor}).

    apply_fn(x_t, t, cond, moe_plan=, generator=, sd_gates=,
    deterministic=, dtype=) replaces the UNet's forward (the pipelined
    forward, parallel/pipelined_unet.py), as the JAX step's apply_fn.
    reduce_grads (a parallel.mesh.DataParallel) makes the step one
    rank's part of a data-parallel step: the latents and labels are this
    rank's rows of the global batch, every draw (the drop uniforms, t,
    the noise; injected t, eps and cond too) is of the global batch, of
    which the rank keeps its rows, as the JAX package draws the global
    batch from one key and shards it (the routing plan and the
    stochastic-depth gates are the batch's, the same on every rank), and
    the gradients are all-reduced (mean) before the optimizer, so the
    clip sees the global gradient. The logged loss is the group's mean.
    With a spatial split (reduce_grads a parallel.mesh.SpatialDataParallel
    and the UNet spatial_parallel) the latents are also only this rank's
    rows of the height, the noise (drawn or injected) is the global
    batch's whole map, of which the rank keeps its rows, and each rank's
    loss is its rows' share of the stripe's mean (the model group's sum,
    as reduce_grads forms it, is the mean).

    state.params must be `unet`. Class-conditional training (num_classes
    > 0 and int labels [B]): each label is replaced by the null class
    num_classes with probability cond_drop (one uniform per label, drawn
    first, and only when labels are given, so an unconditional step
    draws what it always did), and the UNet conditions on the result;
    `cond` injects those class ids in place of labels and the draw. The
    generator draws the drop, t, the noise, the routing plan and the
    stochastic-depth gates, in that order, unless given. The
    loss is value-and-grad of ddpm_loss; every parameter then holds a
    gradient tensor (zeros where the loss does not reach it, as jax.grad
    gives), the optimizer updates in place, and the EMA follows with
    d = min(ema_decay, (1 + step) / (10 + step)) at the step count before
    the increment. Nothing here waits on the device."""

    def step(state: LDMTrainState, x: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
             moe_plan=None, sd_gates=None, labels=None, cond=None):
        if state.params is not unet:
            raise ValueError("state.params is not the UNet this step was made for")
        x = x.float()
        rows = None
        if reduce_grads is not None:
            b_all = x.shape[0] * reduce_grads.world
            rows = reduce_grads.rows(b_all)
            if cond is not None:
                cond = cond[rows]
        if cond is None and labels is not None and num_classes > 0:
            labels = torch.as_tensor(labels, device=x.device).long()
            dev = generator.device if generator is not None else x.device
            shape = labels.shape if rows is None else (b_all,)
            drop = torch.rand(shape, generator=generator, device=dev) < cond_drop
            if rows is not None:
                drop = drop[rows]
            cond = torch.where(drop.to(x.device), num_classes, labels)
        sp = getattr(reduce_grads, "spatial", None)
        if rows is not None:
            # ddpm_loss's draws, of the global batch (and the whole map)
            if t is None:
                t = torch.randint(1, schedule.num_timesteps, (b_all,),
                                  generator=generator, device=x.device)
            if eps is None:
                hw = tuple(x.shape[1:]) if sp is None else (
                    x.shape[1] * sp.world,) + tuple(x.shape[2:])
                eps = torch.randn((b_all,) + hw, generator=generator,
                                  device=x.device, dtype=x.dtype)
            t, eps = t[rows], eps[rows]
            if sp is not None:
                eps = sp.own(eps)
        model = unet
        forward = apply_fn or model
        params = list(model.parameters())
        for p in params:
            p.grad = None

        def denoise(x_t, tt):
            return forward(x_t, tt, cond, moe_plan=moe_plan, generator=generator,
                           sd_gates=sd_gates, deterministic=not stochastic_depth,
                           dtype=dtype).float()

        loss_val = ddpm_loss(denoise, schedule, x, loss=loss,
                             prediction=prediction,
                             min_snr_gamma=min_snr_gamma,
                             generator=generator, t=t, eps=eps)
        if sp is not None:
            loss_val = loss_val * (1.0 / sp.world)
        loss_val.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss_val = loss_val.detach()
        if reduce_grads is not None:
            reduce_grads([p.grad for p in params])
            loss_val = reduce_grads.mean(loss_val)
        opt_state = tx.apply(params, [p.grad for p in params], state.opt_state)
        ema = state.ema_params
        if ema_decay is not None and ema is not None:
            names = [n for n, _ in model.named_parameters()]
            ema_update([ema[n] for n in names], params, state.step, ema_decay)
        new_state = dataclasses.replace(state, opt_state=opt_state,
                                        step=state.step + 1)
        return new_state, {"loss": loss_val}

    return step


@dataclasses.dataclass
class VAETrainState:
    # {"encoder", "decoder", "quantizer"}: the fp32 master weights
    vae_params: nn.ModuleDict
    disc_params: nn.Module        # the Discriminator
    opt_state_vae: Any
    opt_state_disc: Any
    step: int = 0


def random_crop_batch(images: torch.Tensor, crop: int,
                      generator: Optional[torch.Generator] = None,
                      offset=None) -> torch.Tensor:
    """The crop x crop window at one offset (top, left) for the whole
    batch (torchvision RandomCrop on a batched tensor): `offset` (ints or
    tensors), else drawn uniformly from the generator, top first. The
    window is gathered on the images' device by index, so a draw on the
    card costs no host sync."""
    b, h, w, c = images.shape
    if offset is None:
        dev = generator.device if generator is not None else images.device
        offset = tuple(torch.randint(0, n - crop + 1, (1,), generator=generator,
                                     device=dev) for n in (h, w))
    top, left = (torch.as_tensor(o, device=images.device).reshape(1)
                 for o in offset)
    ar = torch.arange(crop, device=images.device)
    return images.index_select(1, top + ar).index_select(2, left + ar)


def make_vae_train_step(encoder: nn.Module, decoder: nn.Module,
                        quantizer: nn.Module, discriminator: nn.Module,
                        tx_vae, tx_disc, weight_recon: float = 10.0,
                        weight_reg: float = 1.0, weight_adv: float = 0.1,
                        crop_size: int = 192, noise_gain: float = 0.1,
                        dtype: Optional[torch.dtype] = None,
                        reduce_grads=None) -> Callable:
    """Returns step(state, images, generator=None, crop_offset=None,
    noise=None) -> (state, metrics, (recon_images, cropped_inputs)).

    state.vae_params must hold encoder, decoder and quantizer, and
    state.disc_params be discriminator. The images (any float dtype, cast
    to fp32 on their device) are cropped at one offset for the batch when
    crop_size is below their size; the generator draws the offset, then
    the latent noise, unless given. The VAE step: loss = weight_recon *
    L1 recon + weight_reg * VQ commitment + weight_adv * relu(-D(y)), its
    gradient over the VAE's parameters only (the discriminator gets none
    from it), tx_vae in place. Then the discriminator's hinge relu(1 +
    D(sg(y))) + relu(1 - D(x)) with the discriminator before its update
    (as the VAE step saw it), tx_disc in place. Every parameter of both
    then holds its gradient (zeros where the loss does not reach it).
    Encoder, decoder and discriminator compute in `dtype` (default: their
    parameters'). Metrics: loss, recon, reg, adv, d_loss. Nothing here
    waits on the device. reduce_grads (a parallel.mesh.DataParallel), as
    in make_ldm_train_step: the images are this rank's rows, the crop
    offset is the batch's and the noise (drawn or injected) the global
    batch's, of which the rank keeps its rows; both nets' gradients are
    all-reduced before their optimizers and the metrics are the group's
    means."""

    def step(state: VAETrainState, images: torch.Tensor,
             generator: Optional[torch.Generator] = None, crop_offset=None,
             noise: Optional[torch.Tensor] = None):
        vae = state.vae_params
        if (vae["encoder"] is not encoder or vae["decoder"] is not decoder
                or vae["quantizer"] is not quantizer
                or state.disc_params is not discriminator):
            raise ValueError("state holds other modules than this step was made for")
        images = images.float()
        if crop_size and crop_size < images.shape[1]:
            images = random_crop_batch(images, crop_size, generator, crop_offset)
        stripe = None
        if reduce_grads is not None:
            b_all = images.shape[0] * reduce_grads.world
            stripe = (b_all, reduce_grads.rows(b_all))
            if noise is not None:
                noise = noise[stripe[1]]
        recon, reg, y = vae_loss(lambda v: encoder(v, dtype=dtype),
                                 lambda v: decoder(v, dtype=dtype), quantizer,
                                 images, noise=noise, generator=generator,
                                 noise_gain=noise_gain, stripe=stripe)
        adv = F.relu(-discriminator(y, dtype=dtype))
        loss = weight_recon * recon + weight_reg * reg + weight_adv * adv
        vae_params = list(vae.parameters())
        grads = _grads(loss, vae_params)
        if reduce_grads is not None:
            reduce_grads(grads)
        opt_vae = tx_vae.apply(vae_params, grads, state.opt_state_vae)

        y = y.detach()
        d_loss = (F.relu(1.0 + discriminator(y, dtype=dtype))
                  + F.relu(1.0 - discriminator(images, dtype=dtype)))
        disc_params = list(discriminator.parameters())
        grads = _grads(d_loss, disc_params)
        if reduce_grads is not None:
            reduce_grads(grads)
        opt_disc = tx_disc.apply(disc_params, grads, state.opt_state_disc)
        new_state = dataclasses.replace(state, opt_state_vae=opt_vae,
                                        opt_state_disc=opt_disc,
                                        step=state.step + 1)
        metrics = {"loss": loss, "recon": recon, "reg": reg, "adv": adv,
                   "d_loss": d_loss}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if reduce_grads is not None:
            means = reduce_grads.mean(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, means.unbind()))
        return new_state, metrics, (y, images)

    return step


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> list:
    """d loss / d params (zeros where it does not reach), each also left
    in its parameter's .grad; no other parameter's .grad is touched."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    out = []
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
        out.append(p.grad)
    return out
