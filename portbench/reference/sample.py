"""The reference's sampling: DDIM over the float32 UNet, classifier-free
guidance, the decoder, uint8 images; computed in blocks of rows. Each
dispatch or call of the program draws its MoE routing plans, one per
denoise step, from a generator it is handed: the reference draws them
again from a generator seeded alike, on the same device."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import unet as ref


def plans(cfg: dict, routing_seed: int, device, num_steps: int) -> list:
    """The pair-id plan of every denoise step: torch.randint over the pair
    table, one id per block, from a generator on `device` seeded with
    routing_seed."""
    g = torch.Generator(device=device).manual_seed(int(routing_seed))
    n_pairs = len(ref.pair_table(cfg["unet"]["num_experts"]))
    n_blocks = len(ref.blocks(cfg["unet"]))
    return [torch.randint(0, n_pairs, (n_blocks,), generator=g, device=device).tolist()
            for _ in range(num_steps)]


@torch.no_grad()
def images(P: dict, D: dict, cfg: dict, noise, routing_seed: int, classes=None,
           guidance: float = 1.0, block: int = 4, rounding=None):
    """(uint8 images [B, S, S, 3], final latents [B, h, w, C] float32) of
    init noise [B, h, w, C] (float32), with class ids [B] and
    classifier-free guidance `guidance` against the null class when the
    UNet is conditional and guidance != 1. rounding: computed with every
    product's operands rounded by it (the control; see
    unet.RoundedProducts)."""
    dev = noise.device
    ab = ref.alpha_bar(cfg["ddpm"]["beta_min"], cfg["ddpm"]["beta_max"],
                       cfg["ddpm"]["num_timesteps"])
    steps = plans(cfg, routing_seed, dev, cfg["num_steps"])
    ucfg = cfg["unet"]
    guided = classes is not None and ucfg["num_classes"] > 0 and guidance != 1.0
    out, lats = [], []
    for lo in range(0, noise.shape[0], block):
        x = noise[lo:lo + block].float()
        cond = null = None
        if classes is not None and ucfg["num_classes"] > 0:
            ids = classes[lo:lo + block].to(dev)
            cond = ref.class_tokens(P, ucfg, ids)
            null = ref.class_tokens(P, ucfg, torch.full_like(ids, ucfg["num_classes"]))
        it = iter(steps)

        def model(x, t):
            plan = next(it)
            tt = torch.full((1,), t, dtype=torch.int64, device=dev)
            pred = ref.unet(P, ucfg, x, tt, plan, None, cond)
            if guided:
                pred_u = ref.unet(P, ucfg, x, tt, plan, None, null)
                pred = pred_u + guidance * (pred - pred_u)
            return pred

        with ref.RoundedProducts(rounding) if rounding else contextlib.nullcontext():
            z = ref.ddim(model, x, ab, cfg["num_steps"])
            out.append(ref.to_uint8(ref.decoder(D, cfg["vae"], z)).cpu())
        lats.append(z.cpu())
    return torch.cat(out), torch.cat(lats)


@torch.no_grad()
def decode(D: dict, cfg: dict, z, block: int = 8) -> torch.Tensor:
    """uint8 images of latents z [B, h, w, C] by the float32 decoder."""
    dev = D["input_layer.kernel"].device
    return torch.cat([ref.to_uint8(ref.decoder(D, cfg["vae"], z[lo:lo + block].to(dev).float())).cpu()
                      for lo in range(0, z.shape[0], block)])


def request_noise(seed: int, shape) -> torch.Tensor:
    """A served request's init noise, as the port's serving CLI draws it: a
    CPU generator seeded with the request's seed, float32."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(int(seed)))


def latent_gap(got, want) -> np.ndarray:
    """Per sample, ||got - want|| / ||want|| of final latents."""
    a, b = torch.as_tensor(got).float().flatten(1), torch.as_tensor(want).float().flatten(1)
    return ((a - b).norm(dim=1) / b.norm(dim=1)).numpy()


def gaps(served, want) -> dict:
    """Per image: mean_abs, the mean absolute difference in uint8 levels;
    p99_abs, its 99th percentile; far_pct, the % of values more than 8
    levels apart."""
    a = torch.as_tensor(np.asarray(served)).float().flatten(1)
    b = torch.as_tensor(np.asarray(want)).float().flatten(1)
    d = (a - b).abs()
    return {"mean_abs": d.mean(1).numpy(),
            "p99_abs": torch.quantile(d, 0.99, dim=1).numpy(),
            "far_pct": (100.0 * (d > 8).float().mean(1)).numpy()}
