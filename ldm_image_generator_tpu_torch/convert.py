"""Carry the JAX package's UNet and VAE (Encoder, Decoder, VectorQuantizer,
Discriminator) params into the port.

The port keeps the flax parameter names and shapes, so a flax tree
(nested dicts of numpy arrays, optionally under a top-level "params")
flattens to the module's state_dict keys by joining the path with dots:
params/enc_stage_0/block_0/ffn/wa -> enc_stage_0.block_0.ffn.wa. Every
leaf must find its parameter and every parameter its leaf, with equal
shapes, or the load raises. ``flax_tree`` is the inverse: a module's
state_dict as the nested {"params": ...} tree of numpy arrays that the
JAX package's save_params writes; ``load_flax_file`` and
``save_flax_file`` read and write such files (utils/checkpoint.py).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ldm_image_generator_tpu_torch.config import (
    DiscriminatorConfig,
    UNetConfig,
    VAEConfig,
)
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import (
    Decoder,
    Discriminator,
    Encoder,
    VectorQuantizer,
)
from ldm_image_generator_tpu_torch.utils.checkpoint import load_params, save_params


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """{'a.b.c': leaf} from nested mappings {'a': {'b': {'c': leaf}}};
    a leaf stays a torch tensor or becomes a numpy array."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, name))
        else:
            out[name] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _as_tensor(leaf) -> torch.Tensor:
    """A CPU tensor of a leaf's values (a numpy bfloat16 leaf, which
    torch.from_numpy does not take, through its raw bits)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if leaf.dtype.name == "bfloat16":
        return torch.from_numpy(leaf.view(np.int16).copy()).view(torch.bfloat16)
    if not leaf.flags.writeable:
        leaf = leaf.copy()
    return torch.from_numpy(leaf)


def mismatch_message(source: str, what: str) -> str:
    """The JAX CLIs' message for a parameter file of another model config
    (ldm_image_generator_tpu/cli/common.py maybe_load)."""
    return (f"Error: checkpoint {source!r} does not match this model config "
            f"({what}). Check the --config preset and that the checkpoint was "
            "trained for this model.")


def load_flax_params(module: nn.Module, tree: Mapping,
                     source: str = "the given tree") -> nn.Module:
    """Copy a flax param tree into `module` in place (values cast to each
    parameter's dtype and device). A missing or extra name raises
    KeyError, a misshapen one ValueError, each with
    mismatch_message(source, ...)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = flatten_tree(tree)
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(mismatch_message(
            source, f"param names differ: missing {missing[:8]} ({len(missing)}), "
                    f"extra {extra[:8]} ({len(extra)})"))
    for name, dst in state.items():
        src = flat[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(mismatch_message(
                source, f"param {name} shape {tuple(src.shape)} vs expected "
                        f"{tuple(dst.shape)}"))
    with torch.no_grad():
        for name, dst in state.items():
            dst.copy_(_as_tensor(flat[name]))
    return module


def flax_tree(module) -> dict:
    """{"params": nested tree} of a module's state_dict (or of a {dotted
    name: tensor} dict, such as the trainer's EMA) as numpy arrays
    (bfloat16 tensors stay tensors: numpy has no such type), the layout
    the JAX package's parameter files hold."""
    state = module.state_dict() if isinstance(module, nn.Module) else module
    root: dict = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        t = t.detach().cpu()
        node[leaf] = t if t.dtype == torch.bfloat16 else t.numpy()
    return {"params": root}


def load_flax_file(module: nn.Module, path: str, torch_converter=None) -> nn.Module:
    """load_flax_params from a parameter file (utils/checkpoint.py), or
    from a reference torch state_dict file through torch_converter."""
    return load_flax_params(module, load_params(path, torch_converter), source=path)


def save_flax_file(module, path: str) -> None:
    """Write a module's parameters (or a {dotted name: tensor} dict) as a
    flax parameter file ({"params": ...}), atomically."""
    save_params(path, flax_tree(module))


def unet_from_flax(tree: Mapping, cfg: UNetConfig, device="cuda") -> UNet:
    """A port UNet holding the JAX UNet's params."""
    return load_flax_params(UNet(cfg, device=device), tree)


def decoder_from_flax(tree: Mapping, cfg: VAEConfig, device="cuda") -> Decoder:
    """A port Decoder holding the JAX Decoder's params."""
    return load_flax_params(Decoder(cfg, device=device), tree)


def encoder_from_flax(tree: Mapping, cfg: VAEConfig, device="cuda") -> Encoder:
    """A port Encoder holding the JAX Encoder's params."""
    return load_flax_params(Encoder(cfg, device=device), tree)


def quantizer_from_flax(tree: Mapping, cfg: VAEConfig,
                        device="cuda") -> VectorQuantizer:
    """A port VectorQuantizer holding the JAX quantizer's codebook."""
    return load_flax_params(
        VectorQuantizer(cfg.num_embeddings, cfg.embedding_dim, device=device), tree)


def discriminator_from_flax(tree: Mapping, cfg: DiscriminatorConfig,
                            device="cuda") -> Discriminator:
    """A port Discriminator holding the JAX Discriminator's params."""
    return load_flax_params(Discriminator(cfg, device=device), tree)
