"""Weights made from a seed, on the device, in a few large calls: one
normal draw for every parameter of a model, cut into its leaves and
scaled: kernels at lecun scale (std 1 / sqrt(fan_in)), biases at std
0.02, a class embedding at std 1 / sqrt(features). The benchmark hands
the same dict to the program under test and to the reference."""
from __future__ import annotations

import math
from typing import Dict

import torch

BIAS_STD = 0.02
# offsets of the models' draws in one run: each model's generator is
# seeded apart, so adding a model never moves another's weights
STREAMS = {"unet": 1, "decoder": 2}


def make(shapes: Dict[str, tuple], seed: int, stream: str, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for shapes {name: (shape, fan_in | None | 'embed')},
    each leaf a view of one buffer drawn in `dtype` from a generator on
    `device` seeded from (seed, stream)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + STREAMS[stream]) % (2 ** 63 - 1))
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    with torch.no_grad():
        for name, (shape, fan) in shapes.items():
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            off += n
            if fan == "embed":
                std = shape[-1] ** -0.5
            elif fan is None:
                std = BIAS_STD
            else:
                std = fan ** -0.5
            leaf.mul_(std)
            out[name] = leaf
    return out
