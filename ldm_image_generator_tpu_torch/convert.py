"""Carry the JAX package's UNet and Decoder params into the port's modules.

The port keeps the flax parameter names and shapes, so a flax tree
(nested dicts of numpy arrays, optionally under a top-level "params")
flattens to the module's state_dict keys by joining the path with dots:
params/enc_stage_0/block_0/ffn/wa -> enc_stage_0.block_0.ffn.wa. Every
leaf must find its parameter and every parameter its leaf, with equal
shapes, or the load raises.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import Decoder


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """{'a.b.c': array} from nested mappings {'a': {'b': {'c': array}}}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def load_flax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax param tree into `module` in place (values cast to each
    parameter's dtype and device). Raises on a missing, extra or
    misshapen name."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = flatten_tree(tree)
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"param names differ: missing {missing[:8]} "
                       f"({len(missing)}), extra {extra[:8]} ({len(extra)})")
    with torch.no_grad():
        for name, dst in state.items():
            src = flat[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {src.shape}, module has "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
    return module


def unet_from_flax(tree: Mapping, cfg: UNetConfig, device="cuda") -> UNet:
    """A port UNet holding the JAX UNet's params."""
    return load_flax_params(UNet(cfg, device=device), tree)


def decoder_from_flax(tree: Mapping, cfg: VAEConfig, device="cuda") -> Decoder:
    """A port Decoder holding the JAX Decoder's params."""
    return load_flax_params(Decoder(cfg, device=device), tree)
