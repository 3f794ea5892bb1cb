"""The reference's training steps: the L1 eps-prediction loss of the
float32 UNet, its gradients summed over blocks of rows, AdamW as optax
defines it (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
parameter, bias corrections in float32) and the EMA with decay
min(d, (1 + step) / (10 + step))."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import unet as ref

F32 = np.float32


def adamw(p, g, mu, nu, count: int, lr: float, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4):
    """One optax.adamw update in place; count is the step's number (1 for
    the first)."""
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).add_(g * g, alpha=1 - b2)
    bc1 = float(F32(1) - F32(b1) ** F32(count))
    bc2 = float(F32(1) - F32(b2) ** F32(count))
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p
    p.add_(u, alpha=-float(F32(lr)))


def ema(e, p, step: int, decay: float):
    """e = d e + (1 - d) p, d = min(decay, (1 + step) / (10 + step)) at the
    step count before the increment."""
    d = min(F32(decay), (F32(1) + F32(step)) / (F32(10) + F32(step)))
    e.lerp_(p, float(F32(1) - d))


def steps(P: dict, cfg: dict, traffic: dict, feeds, block: int = 4, rounding=None) -> dict:
    """Run len(feeds) train steps from the float32 parameters P (updated
    in place); feeds: [(x, t, eps, plan, keeps)], the rows of each step.
    Returns {losses, grad_norms (first step, per leaf), change_norms and
    ema_change_norms (after the last step, per leaf)} keyed by leaf name
    where per leaf. rounding: the forward's product operands rounded by it
    (the control; see unet.RoundedProducts), gradients straight through."""
    ucfg = cfg["unet"]
    d = cfg["ddpm"]
    ab = ref.alpha_bar(d["beta_min"], d["beta_max"], d["num_timesteps"])
    names = list(P)
    p0 = {n: P[n].detach().clone() for n in names}
    e = {n: P[n].detach().clone() for n in names}
    mu = {n: torch.zeros_like(P[n]) for n in names}
    nu = {n: torch.zeros_like(P[n]) for n in names}
    out = {"losses": []}
    for k, (x, t, eps, plan, keeps) in enumerate(feeds):
        leaves = {n: P[n].detach().requires_grad_(True) for n in names}
        grads = {n: torch.zeros_like(P[n]) for n in names}
        total = 0.0
        plan_l = [int(i) for i in plan.tolist()]
        keeps_f = keeps.float()
        b = x.shape[0]
        for lo in range(0, b, block):
            sl = slice(lo, lo + block)
            with ref.RoundedProducts(rounding) if rounding else contextlib.nullcontext():
                loss = ref.l1_loss(leaves, ucfg, ab, x[sl].float(), t[sl], eps[sl].float(),
                                   plan_l, keeps_f, None, batch=b)
            gs = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
            for n, gr in zip(names, gs):
                if gr is not None:
                    grads[n] += gr
            total += float(loss.detach())
        out["losses"].append(total)
        if k == 0:
            out["grad_norms"] = {n: float(grads[n].norm()) for n in names}
        with torch.no_grad():
            for n in names:
                adamw(P[n], grads[n], mu[n], nu[n], k + 1, traffic["learning_rate"])
                ema(e[n], P[n], k, traffic["ema_decay"])
        del leaves, grads
    with torch.no_grad():
        out["change_norms"] = {n: float((P[n] - p0[n]).norm()) for n in names}
        out["ema_change_norms"] = {n: float((e[n] - p0[n]).norm()) for n in names}
    return out
