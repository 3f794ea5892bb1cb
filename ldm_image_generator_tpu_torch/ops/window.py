"""Swin-style window partitioning, padding and shift for NHWC maps.

The shifted path rolls the boolean pad mask along with the activations
(the mask is rolled, never built from rolled activations).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_to_window_multiple(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, int, int]:
    """Zero-pad H and W (dims 1, 2) up to multiples of ws. Returns (x, H, W)."""
    _, h, w, _ = x.shape
    pad_h = (-h) % ws
    pad_w = (-w) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    return x, h, w


def pad_mask(h: int, w: int, hp: int, wp: int, device=None) -> torch.Tensor:
    """Boolean [Hp, Wp] mask, True where the position is padding."""
    row_pad = torch.arange(hp, device=device) >= h
    col_pad = torch.arange(wp, device=device) >= w
    return row_pad[:, None] | col_pad[None, :]


def partition_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nH * nW, ws*ws, C]; H, W multiples of ws."""
    b, h, w, c = x.shape
    if h % ws or w % ws:
        raise ValueError(f"map {h}x{w} is not a multiple of window {ws}")
    nh, nw = h // ws, w // ws
    x = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, ws * ws, c)


def merge_windows(x: torch.Tensor, b: int, h: int, w: int, ws: int) -> torch.Tensor:
    """Inverse of partition_windows: [B*nH*nW, ws*ws, C] -> [B, H, W, C]."""
    nh, nw = h // ws, w // ws
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_2d(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Cyclic shift over the spatial dims (NHWC dims 1, 2)."""
    if shift == 0:
        return x
    return torch.roll(x, (shift, shift), dims=(1, 2))
