"""Export flax-layout parameter trees as the reference's PyTorch
state_dicts, the port's copy of ldm_image_generator_tpu/utils/
torch_export.py.

The exact inverse of ``torch_import``: each function maps a flax
parameter tree (``convert.flax_tree(module)`` of a port module, or a tree
the JAX package's save_params wrote) back onto the reference's flat
per-module ``state_dict`` names, so a model trained here can be handed
back to the reference codebase (torch.load + load_state_dict, strict).

Layout conversions (flax NHWC -> torch NCHW):
  Conv kernel [kh, kw, I, O]  -> Conv2d [O, I, kh, kw]
  Dense kernel [I, O]         -> Conv2d 1x1 [O, I, 1, 1] (the reference
      uses 1x1 convs where the port uses Dense)
  ConvTranspose kernel [kh, kw, I, O] (spatially flipped on import)
      -> unflip -> ConvTranspose2d [I, O, kh, kw]
  Separate q/k/v Dense [C, C] -> MultiheadAttention packed in_proj [3C, C].

Returns dicts of float32 numpy arrays; ``save_state_dict`` wraps them as
torch tensors for ``torch.save``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ldm_image_generator_tpu_torch.config import (
    DiscriminatorConfig,
    UNetConfig,
    VAEConfig,
)


def _np(x) -> np.ndarray:
    # numpy or tensor leaves (a bfloat16 one is a tensor: numpy has no such
    # type) -> float32 numpy; params are fp32 by convention so no precision
    # is lost.
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x).astype(np.float32)


def conv_weight(kernel) -> np.ndarray:
    return _np(kernel).transpose(3, 2, 0, 1)


def one_by_one_from_dense(kernel) -> np.ndarray:
    return _np(kernel).T[:, :, None, None]


def linear_from_dense(kernel) -> np.ndarray:
    return _np(kernel).T


def convtranspose_weight(kernel) -> np.ndarray:
    k = _np(kernel)[::-1, ::-1]  # undo the import-side spatial flip
    # .copy() (not ascontiguousarray): the flip view has negative strides,
    # which torch.from_numpy rejects even on size-1 dims — and on size-1
    # dims the array still counts as "contiguous", making
    # ascontiguousarray a no-op that keeps them
    return k.transpose(2, 3, 0, 1).copy()


def _conv(out: Dict, p: Mapping, prefix: str, one_by_one: bool = False):
    k = p["kernel"]
    out[prefix + ".weight"] = (
        one_by_one_from_dense(k) if one_by_one else conv_weight(k)
    )
    out[prefix + ".bias"] = _np(p["bias"])


def _convtranspose(out: Dict, p: Mapping, prefix: str):
    out[prefix + ".weight"] = convtranspose_weight(p["kernel"])
    out[prefix + ".bias"] = _np(p["bias"])


def _resblock(out: Dict, p: Mapping, prefix: str):
    _conv(out, p["c1"], prefix + ".c1")
    _conv(out, p["c2"], prefix + ".c2")


def _resstack(out: Dict, p: Mapping, prefix: str, n: int):
    for j in range(n):
        _resblock(out, p[f"res_{j}"], f"{prefix}.seq.{j}")


def export_encoder(params: Mapping,
                   cfg: VAEConfig = VAEConfig()) -> Dict[str, np.ndarray]:
    p = params["params"]
    out: Dict[str, np.ndarray] = {}
    _conv(out, p["input_layer"], "input_layer", one_by_one=True)
    _conv(out, p["output_layer"], "output_layer", one_by_one=True)
    n = len(cfg.encoder_channels)
    for i, l in enumerate(cfg.encoder_stages):
        _resstack(out, p[f"stage_{i}"], f"stages.{i}", l)
        if i != n - 1:
            _conv(out, p[f"down_{i}"], f"downsamples.{i}.1", one_by_one=True)
    return out


def export_decoder(params: Mapping,
                   cfg: VAEConfig = VAEConfig()) -> Dict[str, np.ndarray]:
    p = params["params"]
    out: Dict[str, np.ndarray] = {}
    _conv(out, p["input_layer"], "input_layer", one_by_one=True)
    # The reference Decoder constructs an output_layer its forward never
    # uses (vae.py:109,122 — the progressive to_rgb pyramid is the real
    # output path), so we have no counterpart; emit zeros so strict
    # load_state_dict sees every reference key.
    last = cfg.decoder_channels[-1]
    out["output_layer.weight"] = np.zeros(
        (cfg.input_channels, last, 1, 1), np.float32)
    out["output_layer.bias"] = np.zeros((cfg.input_channels,), np.float32)
    for i, l in enumerate(cfg.decoder_stages):
        st = p[f"stage_{i}"]
        for j in range(l):
            _resblock(out, st["layers"][f"res_{j}"], f"stages.{i}.layers.{j}")
        _conv(out, st["to_rgb"], f"stages.{i}.to_rgb", one_by_one=True)
        if i != 0:
            _convtranspose(out, p[f"up_{i}"], f"upsamples.{i}")
    return out


def export_quantizer(params: Mapping) -> Dict[str, np.ndarray]:
    return {"embeddings": _np(params["params"]["embeddings"])}


def export_discriminator(
    params: Mapping, cfg: DiscriminatorConfig = DiscriminatorConfig()
) -> Dict[str, np.ndarray]:
    p = params["params"]
    out: Dict[str, np.ndarray] = {}
    _conv(out, p["input_layer"], "input_layer")
    n = len(cfg.channels)
    for i, l in enumerate(cfg.stages):
        _resstack(out, p[f"stage_{i}"], f"stages.{i}", l)
        _conv(out, p[f"early_exit_{i}"], f"early_exits.{i}", one_by_one=True)
        if i != n - 1:
            _conv(out, p[f"down_{i}"], f"downsamples.{i}")
    return out


def _mha(out: Dict, p: Mapping, prefix: str):
    out[prefix + ".in_proj_weight"] = np.concatenate(
        [_np(p["wq"]).T, _np(p["wk"]).T, _np(p["wv"]).T], axis=0
    )
    out[prefix + ".in_proj_bias"] = np.concatenate(
        [_np(p["bq"]), _np(p["bk"]), _np(p["bv"])]
    )
    out[prefix + ".out_proj.weight"] = linear_from_dense(p["wo"])
    out[prefix + ".out_proj.bias"] = _np(p["bo"])


def _random_moe(out: Dict, p: Mapping, prefix: str, num_experts: int):
    out[prefix + ".general.a.weight"] = one_by_one_from_dense(p["gwa"])
    out[prefix + ".general.a.bias"] = _np(p["gba"])
    out[prefix + ".general.b.weight"] = one_by_one_from_dense(p["gwb"])
    out[prefix + ".general.b.bias"] = _np(p["gbb"])
    out[prefix + ".general.c.weight"] = one_by_one_from_dense(p["gwc"])
    out[prefix + ".general.c.bias"] = _np(p["gbc"])
    for e in range(num_experts):
        ep = f"{prefix}.experts.{e}"
        for name, w, b in (("a", "wa", "ba"), ("b", "wb", "bb"),
                           ("c", "wc", "bc")):
            out[ep + f".{name}.weight"] = one_by_one_from_dense(p[w][e])
            out[ep + f".{name}.bias"] = _np(p[b][e])


def _encodings(out: Dict, p: Mapping, prefix: str):
    _conv(out, p["proj1"], prefix + ".proj1", one_by_one=True)
    _conv(out, p["proj2"], prefix + ".proj2", one_by_one=True)


def _swin_block(out: Dict, p: Mapping, prefix: str, attention: bool,
                num_experts: int):
    _encodings(out, p["encodings"], prefix + ".encodings")
    _random_moe(out, p["ffn"], prefix + ".ffn", num_experts)
    _conv(out, p["conv"], prefix + ".conv")
    if attention:
        _mha(out, p["self_attention"]["mha"],
             prefix + ".self_attention.attention")
        _mha(out, p["cross_attention"]["mha"],
             prefix + ".cross_attention.attention")


def _swin_stack(out: Dict, p: Mapping, prefix: str, num_blocks: int,
                attention: bool, num_experts: int):
    for j in range(num_blocks):
        attn = attention and j >= num_blocks - 2
        _swin_block(out, p[f"block_{j}"], f"{prefix}.blocks.{j}", attn,
                    num_experts)


def export_unet(params: Mapping,
                cfg: UNetConfig = UNetConfig()) -> Dict[str, np.ndarray]:
    """Inverse of torch_import.convert_unet: the reference builds
    decoder_stages with insert(0, ...) (unet.py:84-85), so our stage i
    lands at its index k = n-1-i."""
    p = params["params"]
    if cfg.num_classes > 0 or "class_embed" in p:
        raise ValueError(
            "class-conditional UNets have no reference equivalent to "
            "export to (the reference hardcodes condition=None, "
            "ddpm.py:78); export the unconditional config only"
        )
    n = len(cfg.channels)
    out: Dict[str, np.ndarray] = {}
    _conv(out, p["encoder_first"], "encoder_first")
    _convtranspose(out, p["decoder_last"], "decoder_last")
    for i, l in enumerate(cfg.stages):
        _swin_stack(out, p[f"enc_stage_{i}"], f"encoder_stages.{i}.stage",
                    l, False, cfg.num_experts)
        if i != n - 1:
            _conv(out, p[f"enc_chconv_{i}"], f"encoder_stages.{i}.ch_conv.0",
                  one_by_one=True)
        k = n - 1 - i
        _swin_stack(out, p[f"dec_stage_{i}"], f"decoder_stages.{k}.stage",
                    l, True, cfg.num_experts)
        if i != n - 1:
            _conv(out, p[f"dec_chconv_{i}"], f"decoder_stages.{k}.ch_conv.1",
                  one_by_one=True)
    return out


def export_ddpm(params: Mapping,
                cfg: UNetConfig = UNetConfig()) -> Dict[str, np.ndarray]:
    """Wrap under the reference DDPM's ``model.`` prefix (ddpm.py:18)."""
    return {"model." + k: v for k, v in export_unet(params, cfg).items()}


def save_state_dict(path: str, sd: Mapping[str, np.ndarray]) -> None:
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
