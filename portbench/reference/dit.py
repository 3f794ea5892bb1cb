"""The benchmark's copy of the plain float32 DiT reference
(reference_torch/dit.py, which the port's CPU tests hold the program
against): DiT (Peebles & Xie 2022, arXiv:2212.09748; facebookresearch/DiT
models.py) and its sampling, DDIM over the eps channels with
classifier-free guidance, in plain torch operations. The copy adds the
control's rounding (the UNet reference's fp8 e4m3 at every operand of a
matrix product, einsum or convolution: with RoundedProducts(fp8) around
`sample`, every product here is rounded) and is otherwise the same, so
portbench/tests/test_portbench_dit.py holds the two against each other.

It imports nothing of the program under test. Parameters are a dict
{name: tensor} under DiT's state-dict names and shapes (torch Linear
weights [out, in], the patch embedding a Conv2d weight [D, C, p, p]);
`pos_embed` is not a parameter here: the fixed 2-D sin-cos table is
computed. The configuration is a dict of DiT's constructor keys
(input_size, patch_size, in_channels, hidden_size, depth, num_heads,
mlp_ratio, num_classes, learn_sigma). Latents are NHWC, as the program's.
Call ``precise()`` before running it on a card: TF32 off for matrix
products and convolutions.

Departures from DiT's sample.py, the same as the program's: DDIM (eta 0)
over the linear beta schedule in place of 250 DDPM steps, guidance on all
C eps channels (DiT's forward_with_cfg guides the first 3 by default), the
learned variance channels dropped, and the null class id num_classes
(DiT's too).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# the control: products in the precision below bfloat16 (see the docstring)
from portbench.reference.unet import RoundedProducts, control_rounding, fp8  # noqa: F401

Params = Dict[str, torch.Tensor]
FREQUENCIES = 256
LN_EPS = 1e-6


def precise() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def out_channels(cfg: dict) -> int:
    return cfg["in_channels"] * (2 if cfg["learn_sigma"] else 1)


def shapes(cfg: dict) -> Dict[str, tuple]:
    """{parameter name: (shape, fan_in or None for a bias, 'embed')} in
    DiT's state-dict order, pos_embed left out."""
    d, p, c = cfg["hidden_size"], cfg["patch_size"], cfg["in_channels"]
    m = int(d * cfg["mlp_ratio"])
    out = {}
    lin = lambda n, i, o: out.update({f"{n}.weight": ((o, i), i), f"{n}.bias": ((o,), None)})
    out["x_embedder.proj.weight"] = ((d, c, p, p), c * p * p)
    out["x_embedder.proj.bias"] = ((d,), None)
    lin("t_embedder.mlp.0", FREQUENCIES, d)
    lin("t_embedder.mlp.2", d, d)
    out["y_embedder.embedding_table.weight"] = ((cfg["num_classes"] + 1, d), "embed")
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        lin(f"{b}.attn.qkv", d, 3 * d)
        lin(f"{b}.attn.proj", d, d)
        lin(f"{b}.mlp.fc1", d, m)
        lin(f"{b}.mlp.fc2", m, d)
        lin(f"{b}.adaLN_modulation.1", d, 6 * d)
    lin("final_layer.linear", d, p * p * out_channels(cfg))
    lin("final_layer.adaLN_modulation.1", d, 2 * d)
    return out


# --- fixed tables -------------------------------------------------------------

def sincos(dim: int, pos: np.ndarray) -> np.ndarray:
    """DiT's get_1d_sincos_pos_embed_from_grid: [M, dim] float64."""
    omega = np.arange(dim // 2, dtype=np.float64)
    omega /= dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed(dim: int, grid: int) -> np.ndarray:
    """DiT's get_2d_sincos_pos_embed: [grid * grid, dim] float64."""
    g = np.stack(np.meshgrid(np.arange(grid, dtype=np.float32),
                             np.arange(grid, dtype=np.float32)), axis=0)
    g = g.reshape(2, 1, grid, grid)
    return np.concatenate([sincos(dim // 2, g[0]), sincos(dim // 2, g[1])], axis=1)


def timestep_embedding(t, dim: int = FREQUENCIES):
    """DiT's TimestepEmbedder.timestep_embedding: [N, dim], cos then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(0, half, dtype=torch.float32,
                                                      device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# --- layers ---------------------------------------------------------------------

def linear(P: Params, name: str, x):
    return x @ P[f"{name}.weight"].t() + P[f"{name}.bias"]


def layer_norm(x):
    """LayerNorm over the last axis, no affine, eps 1e-6."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(P: Params, name: str, x, heads: int):
    """timm's Attention: fused qkv, softmax(q k^T / sqrt(hd)) v, proj."""
    b, n, d = x.shape
    hd = d // heads
    qkv = linear(P, f"{name}.qkv", x).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    a = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
    return linear(P, f"{name}.proj", (a @ v).transpose(1, 2).reshape(b, n, d))


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def forward(P: Params, cfg: dict, x, t, y):
    """DiT.forward on NHWC latents: x [B, H, W, C], t [1 or B] timesteps,
    y [B] class ids (num_classes: the null class) -> [B, H, W,
    out_channels] float32."""
    b, h, w, c = x.shape
    p, d, heads = cfg["patch_size"], cfg["hidden_size"], cfg["num_heads"]
    tok = F.conv2d(x.permute(0, 3, 1, 2), P["x_embedder.proj.weight"],
                   P["x_embedder.proj.bias"], stride=p)
    tok = tok.flatten(2).transpose(1, 2)
    tok = tok + torch.from_numpy(pos_embed(d, h // p)).float().to(x.device)[None]
    t_emb = timestep_embedding(t)
    t_emb = linear(P, "t_embedder.mlp.2", F.silu(linear(P, "t_embedder.mlp.0", t_emb)))
    cond = t_emb + P["y_embedder.embedding_table.weight"][y.long()]
    s = F.silu(cond)
    for i in range(cfg["depth"]):
        blk = f"blocks.{i}"
        sh1, sc1, g1, sh2, sc2, g2 = linear(P, f"{blk}.adaLN_modulation.1", s).chunk(6, dim=1)
        tok = tok + g1[:, None] * attention(P, f"{blk}.attn",
                                            modulate(layer_norm(tok), sh1, sc1), heads)
        hid = gelu_tanh(linear(P, f"{blk}.mlp.fc1", modulate(layer_norm(tok), sh2, sc2)))
        tok = tok + g2[:, None] * linear(P, f"{blk}.mlp.fc2", hid)
    sh, sc = linear(P, "final_layer.adaLN_modulation.1", s).chunk(2, dim=1)
    tok = linear(P, "final_layer.linear", modulate(layer_norm(tok), sh, sc))
    oc = out_channels(cfg)
    # DiT's unpatchify (N, h, w, p, p, c) -> (N, c, h p, w p), here NHWC
    tok = tok.reshape(b, h // p, w // p, p, p, oc).permute(0, 1, 3, 2, 4, 5)
    return tok.reshape(b, h, w, oc)


# --- sampling -------------------------------------------------------------------

def alpha_bar(beta_min: float = 1e-4, beta_max: float = 0.02, steps: int = 1000) -> np.ndarray:
    """float32 cumulative product of 1 - beta over a linear beta schedule
    built in float64 (DiT's `linear` schedule at these defaults)."""
    beta = np.linspace(beta_min, beta_max, steps, dtype=np.float64)
    return np.cumprod(1.0 - beta).astype(np.float32)


def ddim_steps(num_timesteps: int, num_steps: int) -> List[tuple]:
    """(t, t_next) from the last timestep down: linspace(0, T - 1, n)
    truncated to int, t_next the previous point (0 before the first)."""
    s = np.linspace(0, num_timesteps - 1, num_steps).astype(np.int32)
    nxt = np.concatenate([[0], s[:-1]]).astype(np.int32)
    return list(zip(s[::-1].tolist(), nxt[::-1].tolist()))


def ddim(model, x, ab: np.ndarray, num_steps: int):
    """Deterministic DDIM (eta 0) over eps predictions model(x, t) -> the
    final x0 estimate."""
    one = np.float32(1.0)
    for t, t_next in ddim_steps(len(ab), num_steps):
        eps = model(x, t)
        a_t = ab[t]
        x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
        if t == 0:
            x = x0
        else:
            a_n = ab[t_next]
            x = float(np.sqrt(a_n)) * x0 + float(np.sqrt(one - a_n)) * eps
    return x


@torch.no_grad()
def sample(P: Params, cfg: dict, noise, classes, guidance: float, num_steps: int,
           ab: np.ndarray):
    """Final latents [B, H, W, C] of DDIM from init noise [B, H, W, C]
    (float32) for class ids [B]; guidance != 1 guides the eps channels
    against the null class: e_u + guidance (e_c - e_u)."""
    c = cfg["in_channels"]
    null = torch.full_like(classes, cfg["num_classes"])

    def model(x, t):
        tt = torch.full((1,), t, dtype=torch.int64, device=x.device)
        e_c = forward(P, cfg, x, tt, classes)[..., :c]
        if guidance == 1.0:
            return e_c
        e_u = forward(P, cfg, x, tt, null)[..., :c]
        return e_u + guidance * (e_c - e_u)

    return ddim(model, noise.float(), ab, num_steps)
