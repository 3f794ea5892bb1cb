"""Sinusoidal positional and time encodings (NHWC).

Channel layouts (C = number of channels):
  positional_encoding_2d -> [sin_v C/4 | cos_v C/4 | sin_h C/4 | cos_h C/4]
    with v = row/H, h = col/W and octave factors f_i = 1 / 2**(i / (C/4));
  time_encoding_2d -> [sin C/2 | cos C/2] with f_i = 1 / 10000**(i / (C/2)).
Both multiply the phase by pi.
"""
from __future__ import annotations

import math

import torch


def positional_encoding_2d(h: int, w: int, channels: int,
                           dtype=torch.float32, device=None) -> torch.Tensor:
    """[H, W, C] positional encoding (broadcasts over the batch)."""
    if channels % 4:
        raise ValueError(f"channels must be divisible by 4, got {channels}")
    quarter = channels // 4
    f32 = dict(dtype=torch.float32, device=device)
    factors = 1.0 / (2.0 ** (torch.arange(quarter, **f32) / quarter))
    v = (torch.arange(h, **f32) / h)[:, None]
    u = (torch.arange(w, **f32) / w)[:, None]
    pv = v * math.pi * factors[None, :]
    ph = u * math.pi * factors[None, :]
    ev = torch.cat([torch.sin(pv), torch.cos(pv)], dim=-1)  # [H, C/2]
    eh = torch.cat([torch.sin(ph), torch.cos(ph)], dim=-1)  # [W, C/2]
    emb = torch.cat(
        [ev[:, None, :].expand(h, w, channels // 2),
         eh[None, :, :].expand(h, w, channels // 2)],
        dim=-1,
    )
    return emb.to(dtype)


def time_encoding_2d(t: torch.Tensor, channels: int,
                     max_timesteps: int = 10000,
                     dtype=torch.float32) -> torch.Tensor:
    """[B, 1, 1, C] time encoding for timesteps t: [B]."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    half = channels // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    factors = 1.0 / (float(max_timesteps) ** (ar / half))
    phase = t.float()[:, None] * math.pi * factors[None, :]
    emb = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)
    return emb[:, None, None, :].to(dtype)
