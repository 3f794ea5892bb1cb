"""Diffusion transformer (DiT; Peebles & Xie 2022, arXiv:2212.09748;
facebookresearch/DiT models.py), a denoiser LDMPipeline takes in the
UNet's place.

Patchify (a stride-p conv, here a product over p x p x C patches) plus a
fixed 2-D sin-cos position table -> `depth` adaLN-Zero blocks -> an adaLN
final layer -> unpatchify. Conditioning c = t_emb + y_emb: the timestep's
256 frequencies (cos, then sin) through Linear, SiLU, Linear, plus a row
of the class table (row num_classes: the null class of classifier-free
guidance). Each block modulates with SiLU(c) -> Linear(D, 6D), per row:

    x += gate_msa * attn(LN(x) * (1 + scale_msa) + shift_msa)
    x += gate_mlp * mlp(LN(x) * (1 + scale_mlp) + shift_mlp)

LN a LayerNorm with no affine at eps 1e-6, attn global multi-head
self-attention over every token, mlp Linear, tanh-GELU, Linear.

Parameters carry DiT's state-dict names and shapes (torch Linear weights
[out, in], the patch embedding a Conv2d weight [D, C, p, p], `pos_embed`
[1, T, D] a frozen parameter holding the fixed table), so DiT's files
load with strict=True. Activations are NHWC at the module's edge, as the
UNet's: x [B, H, W, C] -> [B, H, W, out_channels], the eps prediction in
the first C channels and, with learn_sigma, the variance's interpolation
in the rest. Compute runs in the parameters' dtype (the pipeline's bf16
copy): products through F.linear, attention through
F.scaled_dot_product_attention.

Seeded weights (no file): lecun-normal kernels, zero biases, the class
table N(0, 1/D). DiT's own init zeroes the adaLN projections and the final
layer, which makes every block an identity; here every block computes.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ldm_image_generator_tpu_torch.config import DiTConfig, resolve_device
from ldm_image_generator_tpu_torch.models.layers import ParamInit
from ldm_image_generator_tpu_torch.utils.profiling import span

# the timestep embedder's sinusoid width (DiT's frequency_embedding_size)
FREQUENCIES = 256
LN_EPS = 1e-6


def sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    """[M, dim] float64: sin then cos of pos / 10000^(2i / dim)."""
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.outer(pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed_table(dim: int, grid: int) -> np.ndarray:
    """DiT's get_2d_sincos_pos_embed(dim, grid): [grid^2, dim] float64,
    token i * grid + j at row i, column j; its first half encodes the
    column, its second the row (np.meshgrid's order)."""
    cols, rows = np.meshgrid(np.arange(grid, dtype=np.float32),
                             np.arange(grid, dtype=np.float32))
    return np.concatenate([sincos_1d(dim // 2, cols), sincos_1d(dim // 2, rows)], axis=1)


def timestep_frequencies(t: torch.Tensor, dim: int = FREQUENCIES) -> torch.Tensor:
    """[N, dim] float32: cos then sin of t * 10000^(-i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / half)
    args = t.reshape(-1, 1).float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def modulate(x, shift, scale):
    """x (1 + scale) + shift in one pass over x."""
    return torch.addcmul(shift, x, 1 + scale)


class Linear(nn.Module):
    """torch's Linear layout (weight [out, in], bias [out]) with flax's
    lecun-normal init from a ParamInit."""

    def __init__(self, din: int, dout: int, init: ParamInit):
        super().__init__()
        self.weight = init.lecun(dout, din, fan_in=din)
        self.bias = init.zeros(dout)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class PatchEmbed(nn.Module):
    """timm's PatchEmbed as DiT holds it: proj, a Conv2d [D, C, p, p] of
    stride p."""

    def __init__(self, cin: int, dim: int, p: int, init: ParamInit):
        super().__init__()
        self.proj = nn.Module()
        self.proj.weight = init.lecun(dim, cin, p, p, fan_in=cin * p * p)
        self.proj.bias = init.zeros(dim)


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, init: ParamInit):
        super().__init__()
        self.mlp = nn.Sequential(Linear(FREQUENCIES, dim, init), nn.SiLU(),
                                 Linear(dim, dim, init))


class LabelEmbedder(nn.Module):
    def __init__(self, rows: int, dim: int, init: ParamInit):
        super().__init__()
        self.embedding_table = nn.Module()
        self.embedding_table.weight = init.normal(rows, dim, std=dim ** -0.5)


class Attention(nn.Module):
    """timm's Attention (qkv bias, no q/k norm) as DiT holds it."""

    def __init__(self, dim: int, init: ParamInit):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, init)
        self.proj = Linear(dim, dim, init)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, init: ParamInit):
        super().__init__()
        self.fc1 = Linear(dim, hidden, init)
        self.fc2 = Linear(hidden, dim, init)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, init: ParamInit):
        super().__init__()
        d = cfg.hidden_size
        self.attn = Attention(d, init)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), init)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(d, 6 * d, init))


class FinalLayer(nn.Module):
    def __init__(self, cfg: DiTConfig, init: ParamInit):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.linear = Linear(d, p * p * cfg.out_channels, init)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(d, 2 * d, init))


class DiT(nn.Module):
    """The denoiser on NHWC latents of cfg.input_size^2 (see the module's
    docstring). attention_calls counts the attention calls of every
    forward (a plain integer, as the kernel wrappers' launch counters).

    What LDMPipeline asks of a denoiser (models/unet.py's UNet answers
    the same): cfg.input_channels and cfg.num_classes, prepare(dtype),
    draw_fn(generator), tokens(latent) and takes_film."""

    # called as dit(x, t, condition): no FiLM memo, routing plan or
    # DeepCache features
    takes_film = False

    def __init__(self, cfg: DiTConfig = DiTConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.hidden_size % cfg.num_heads or cfg.hidden_size % 4:
            raise ValueError(f"hidden_size {cfg.hidden_size}: a multiple of 4 and of "
                             f"num_heads ({cfg.num_heads})")
        if cfg.input_size % cfg.patch_size:
            raise ValueError(f"input_size {cfg.input_size}: a multiple of patch_size "
                             f"({cfg.patch_size})")
        dev = resolve_device(device)
        init = ParamInit(dev, generator)
        self.cfg = cfg
        d, grid = cfg.hidden_size, cfg.input_size // cfg.patch_size
        self.x_embedder = PatchEmbed(cfg.in_channels, d, cfg.patch_size, init)
        self.t_embedder = TimestepEmbedder(d, init)
        self.y_embedder = LabelEmbedder(cfg.num_classes + 1, d, init)
        table = torch.from_numpy(pos_embed_table(d, grid)).float()
        self.pos_embed = nn.Parameter(table[None].to(dev), requires_grad=False)
        self.blocks = nn.ModuleList(DiTBlock(cfg, init) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(cfg, init)
        self.attention_calls = 0

    def prepare(self, dtype: torch.dtype) -> None:
        """Nothing to derive ahead of a sampling run."""

    def draw_fn(self, generator: Optional[torch.Generator]):
        """draw() -> one step's routing plan: None, nothing is routed."""
        return lambda: None

    def tokens(self, latent: int) -> int:
        """Tokens per row at a latent of side `latent`."""
        return (latent // self.cfg.patch_size) ** 2

    def condition(self, t, condition, rows: int, dtype) -> torch.Tensor:
        """SiLU(c) [rows, D]: c = t_emb + y_emb for timesteps t [1 or rows]
        and class ids [rows] (None: the null class for every row)."""
        with span("dit.embed", rows=rows):
            mlp = self.t_embedder.mlp
            t_emb = mlp(timestep_frequencies(t).to(dtype))
            table = self.y_embedder.embedding_table.weight
            if condition is None:
                y_emb = table[self.cfg.num_classes].expand(rows, -1)
            else:
                y_emb = table[condition.to(table.device, torch.long)]
            return F.silu(t_emb + y_emb)

    def attend(self, q, k, v):
        """Global attention of q, k, v [B, heads, T, head_dim]."""
        self.attention_calls += 1
        b, h, n, hd = q.shape
        with span("dit.attention", rows=b, tokens=n, heads=h, head_dim=hd):
            return F.scaled_dot_product_attention(q, k, v)

    def forward(self, x, t, condition=None):
        """x [B, H, W, C] latents (cast to the parameters' dtype); t [1 or
        B] timesteps; condition class ids [B] or None (the null class) ->
        [B, H, W, out_channels] in the parameters' dtype."""
        cfg = self.cfg
        b, h, w, c = x.shape
        p, d, heads = cfg.patch_size, cfg.hidden_size, cfg.num_heads
        gh, gw = h // p, w // p
        n = gh * gw
        if h % p or w % p or n != self.pos_embed.shape[1]:
            raise ValueError(f"a {h}x{w} latent: this DiT takes {cfg.input_size}x"
                             f"{cfg.input_size} (patch {p})")
        dt = self.pos_embed.dtype
        silu_c = self.condition(t, condition, b, dt)[:, None]
        proj = self.x_embedder.proj
        patches = x.to(dt).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
        x = F.linear(patches.reshape(b, n, c * p * p), proj.weight.reshape(d, -1),
                     proj.bias) + self.pos_embed
        for blk in self.blocks:
            shift1, scale1, gate1, shift2, scale2, gate2 = \
                blk.adaLN_modulation[1](silu_c).chunk(6, dim=-1)
            a = modulate(F.layer_norm(x, (d,), eps=LN_EPS), shift1, scale1)
            q, k, v = blk.attn.qkv(a).reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
            a = self.attend(q, k, v).transpose(1, 2).reshape(b, n, d)
            x = torch.addcmul(x, gate1, blk.attn.proj(a))
            m = modulate(F.layer_norm(x, (d,), eps=LN_EPS), shift2, scale2)
            x = torch.addcmul(x, gate2, blk.mlp(m))
        fl = self.final_layer
        shift, scale = fl.adaLN_modulation[1](silu_c).chunk(2, dim=-1)
        x = fl.linear(modulate(F.layer_norm(x, (d,), eps=LN_EPS), shift, scale))
        oc = cfg.out_channels
        return x.reshape(b, gh, gw, p, p, oc).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, oc)
