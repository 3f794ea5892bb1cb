"""Convert the reference's PyTorch state_dicts into flax-layout parameter
trees, the port's copy of ldm_image_generator_tpu/utils/torch_import.py.

The reference checkpoints are flat per-module ``state_dict`` files. This
module maps those names onto the flax parameter trees the port's modules
keep (convert.load_flax_params loads such a tree), so reference-trained
weights load at every CLI path that takes a parameter file.

Layout conversions (torch -> flax, NCHW -> NHWC):
  Conv2d kxk   [O, I, kh, kw]  -> Conv kernel [kh, kw, I, O]
  Conv2d 1x1   [O, I, 1, 1]    -> Dense kernel [I, O]
  ConvTranspose2d [I, O, kh, kw] -> ConvTranspose kernel [kh, kw, I, O],
      spatially flipped (torch computes the gradient-of-conv; flax's
      ConvTranspose uses transpose_kernel=False semantics).
  MultiheadAttention packed in_proj [3C, C] -> separate q/k/v Dense [C, C].

The converters take a dict of numpy arrays (or CPU tensors) and return
numpy arrays; a bfloat16 tensor (numpy has no such type) becomes float32,
exactly. ``load_state_dict`` reads a .pt file with torch.load's
weights_only=True.
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


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()  # torch tensor
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """{name: numpy array} of a torch.save'd state_dict (tensors only:
    weights_only=True)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}


def conv_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def dense_from_1x1(w) -> np.ndarray:
    w = _np(w)
    assert w.shape[2:] == (1, 1), w.shape
    return w[:, :, 0, 0].T


def dense_from_linear(w) -> np.ndarray:
    return _np(w).T


def convtranspose_kernel(w) -> np.ndarray:
    w = _np(w)  # [I, O, kh, kw]
    return w.transpose(2, 3, 0, 1)[::-1, ::-1].copy()


def _conv(sd: Mapping, prefix: str, one_by_one: bool = False) -> Dict[str, Any]:
    w = sd[prefix + ".weight"]
    b = _np(sd[prefix + ".bias"])
    if one_by_one:
        return {"kernel": dense_from_1x1(w), "bias": b}
    return {"kernel": conv_kernel(w), "bias": b}


def _convtranspose(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {
        "kernel": convtranspose_kernel(sd[prefix + ".weight"]),
        "bias": _np(sd[prefix + ".bias"]),
    }


def _resblock(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {"c1": _conv(sd, prefix + ".c1"), "c2": _conv(sd, prefix + ".c2")}


def _resstack(sd: Mapping, prefix: str, n: int) -> Dict[str, Any]:
    # reference ResStack stores blocks under .seq.{j} (vae.py:69-71)
    return {f"res_{j}": _resblock(sd, f"{prefix}.seq.{j}") for j in range(n)}


def convert_encoder(sd: Mapping, cfg: VAEConfig = VAEConfig()) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "input_layer": _conv(sd, "input_layer", one_by_one=True),
        "output_layer": _conv(sd, "output_layer", one_by_one=True),
    }
    n = len(cfg.encoder_channels)
    for i, l in enumerate(cfg.encoder_stages):
        p[f"stage_{i}"] = _resstack(sd, f"stages.{i}", l)
        if i != n - 1:
            # downsamples.{i} = Sequential(AvgPool2d, Conv2d 1x1) (vae.py:87-89)
            p[f"down_{i}"] = _conv(sd, f"downsamples.{i}.1", one_by_one=True)
    return {"params": p}


def convert_decoder(sd: Mapping, cfg: VAEConfig = VAEConfig()) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "input_layer": _conv(sd, "input_layer", one_by_one=True),
    }
    for i, l in enumerate(cfg.decoder_stages):
        # reference DecoderStack stores ResBlocks directly under .layers.{j}
        # (nn.Sequential, vae.py:102), unlike ResStack's .seq.{j}
        p[f"stage_{i}"] = {
            "layers": {
                f"res_{j}": _resblock(sd, f"stages.{i}.layers.{j}")
                for j in range(l)
            },
            "to_rgb": _conv(sd, f"stages.{i}.to_rgb", one_by_one=True),
        }
        if i != 0:
            p[f"up_{i}"] = _convtranspose(sd, f"upsamples.{i}")
    return {"params": p}


def convert_quantizer(sd: Mapping) -> Dict[str, Any]:
    return {"params": {"embeddings": _np(sd["embeddings"])}}


def convert_discriminator(
    sd: Mapping, cfg: DiscriminatorConfig = DiscriminatorConfig()
) -> Dict[str, Any]:
    p: Dict[str, Any] = {"input_layer": _conv(sd, "input_layer")}
    n = len(cfg.channels)
    for i, l in enumerate(cfg.stages):
        p[f"stage_{i}"] = _resstack(sd, f"stages.{i}", l)
        p[f"early_exit_{i}"] = _conv(sd, f"early_exits.{i}", one_by_one=True)
        if i != n - 1:
            p[f"down_{i}"] = _conv(sd, f"downsamples.{i}")
    return {"params": p}


def _mha(sd: Mapping, prefix: str) -> Dict[str, Any]:
    # torch packs qkv in in_proj_weight [3C, C] (attention.py:8)
    w = _np(sd[prefix + ".in_proj_weight"])
    b = _np(sd[prefix + ".in_proj_bias"])
    c = w.shape[1]
    return {
        "wq": w[:c].T, "bq": b[:c],
        "wk": w[c : 2 * c].T, "bk": b[c : 2 * c],
        "wv": w[2 * c :].T, "bv": b[2 * c :],
        "wo": dense_from_linear(sd[prefix + ".out_proj.weight"]),
        "bo": _np(sd[prefix + ".out_proj.bias"]),
    }


def _reglu(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {
        "a": _conv(sd, prefix + ".a", one_by_one=True),
        "b": _conv(sd, prefix + ".b", one_by_one=True),
        "c": _conv(sd, prefix + ".c", one_by_one=True),
    }


def _random_moe(sd: Mapping, prefix: str, num_experts: int) -> Dict[str, Any]:
    # the general ReGLU maps to flat gwa/gba/... params (RandomMoE owns
    # them directly so the fused FFN kernel can consume them)
    p = {
        "gwa": dense_from_1x1(sd[prefix + ".general.a.weight"]),
        "gba": _np(sd[prefix + ".general.a.bias"]),
        "gwb": dense_from_1x1(sd[prefix + ".general.b.weight"]),
        "gbb": _np(sd[prefix + ".general.b.bias"]),
        "gwc": dense_from_1x1(sd[prefix + ".general.c.weight"]),
        "gbc": _np(sd[prefix + ".general.c.bias"]),
    }
    wa, wb, wc, ba, bb, bc = [], [], [], [], [], []
    for e in range(num_experts):
        ep = f"{prefix}.experts.{e}"
        wa.append(dense_from_1x1(sd[ep + ".a.weight"]))
        ba.append(_np(sd[ep + ".a.bias"]))
        wb.append(dense_from_1x1(sd[ep + ".b.weight"]))
        bb.append(_np(sd[ep + ".b.bias"]))
        wc.append(dense_from_1x1(sd[ep + ".c.weight"]))
        bc.append(_np(sd[ep + ".c.bias"]))
    p["wa"] = np.stack(wa)
    p["wb"] = np.stack(wb)
    p["wc"] = np.stack(wc)
    p["ba"] = np.stack(ba)
    p["bb"] = np.stack(bb)
    p["bc"] = np.stack(bc)
    return p


def _encodings(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {
        "proj1": _conv(sd, prefix + ".proj1", one_by_one=True),
        "proj2": _conv(sd, prefix + ".proj2", one_by_one=True),
    }


def _swin_block(sd: Mapping, prefix: str, attention: bool,
                num_experts: int) -> Dict[str, Any]:
    p = {
        "encodings": _encodings(sd, prefix + ".encodings"),
        "ffn": _random_moe(sd, prefix + ".ffn", num_experts),
        "conv": _conv(sd, prefix + ".conv"),
    }
    if attention:
        p["self_attention"] = {"mha": _mha(sd, prefix + ".self_attention.attention")}
        p["cross_attention"] = {"mha": _mha(sd, prefix + ".cross_attention.attention")}
    return p


def _swin_stack(sd: Mapping, prefix: str, num_blocks: int, attention: bool,
                num_experts: int) -> Dict[str, Any]:
    p = {}
    for j in range(num_blocks):
        attn = attention and j >= num_blocks - 2
        p[f"block_{j}"] = _swin_block(sd, f"{prefix}.blocks.{j}", attn, num_experts)
    return p


def convert_unet(sd: Mapping, cfg: UNetConfig = UNetConfig()) -> Dict[str, Any]:
    """Map the reference UNet state_dict (unet.py:74-103) to our tree.

    The reference builds decoder_stages with insert(0, ...), so its
    ``decoder_stages.{k}`` holds stage index i = n-1-k.
    """
    n = len(cfg.channels)
    p: Dict[str, Any] = {
        "encoder_first": _conv(sd, "encoder_first"),
        "decoder_last": _convtranspose(sd, "decoder_last"),
    }
    for i, l in enumerate(cfg.stages):
        p[f"enc_stage_{i}"] = _swin_stack(
            sd, f"encoder_stages.{i}.stage", l, False, cfg.num_experts
        )
        if i != n - 1:
            # enc ch_conv = Sequential(Conv1x1, AvgPool) (unet.py:82)
            p[f"enc_chconv_{i}"] = _conv(
                sd, f"encoder_stages.{i}.ch_conv.0", one_by_one=True
            )
        k = n - 1 - i  # reference storage index for our stage i
        p[f"dec_stage_{i}"] = _swin_stack(
            sd, f"decoder_stages.{k}.stage", l, True, cfg.num_experts
        )
        if i != n - 1:
            # dec ch_conv = Sequential(Upsample, Conv1x1) (unet.py:84)
            p[f"dec_chconv_{i}"] = _conv(
                sd, f"decoder_stages.{k}.ch_conv.1", one_by_one=True
            )
    return {"params": p}


def convert_ddpm(sd: Mapping, cfg: UNetConfig = UNetConfig()) -> Dict[str, Any]:
    """The reference DDPM wraps the UNet as self.model (ddpm.py:18); its
    schedule tensors are plain attributes excluded from the state_dict."""
    inner = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return convert_unet(inner, cfg)
