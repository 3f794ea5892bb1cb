"""SwinBlock building blocks (NHWC), torch counterparts of
ldm_image_generator_tpu/models/layers.py.

Parameter names and shapes follow the flax tree (Dense kernels [in, out],
HWIO convs, stacked experts [E, C, M]), so convert.py carries a JAX
checkpoint across by flattening names. Modules compute in the dtype of
their parameters; the pipeline casts them once.

The block body runs through the port's kernel wrappers: block_core at
batch <= 2, ffn_block plus a plain grouped conv above, and window_mha for
the attention blocks. Each wrapper takes its plain version for CPU
tensors and its CUDA kernel for CUDA tensors.

Randomness is explicit: MoE routing arrives as expert ids (from the
UNet's routing plan, a pair id, or fixed indices). Stochastic depth is a
training-time gate and is not applied here (sampling is deterministic).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ldm_image_generator_tpu_torch.kernels.block_core import (
    block_core,
    grouped_conv3x3,
)
from ldm_image_generator_tpu_torch.kernels.ffn_block import ffn_block
from ldm_image_generator_tpu_torch.kernels.window_attention import (
    NEG_INF,
    window_mha,
)
from ldm_image_generator_tpu_torch.ops.sinusoidal import (
    positional_encoding_2d,
    time_encoding_2d,
)
from ldm_image_generator_tpu_torch.ops.window import (
    merge_windows,
    pad_mask,
    pad_to_window_multiple,
    partition_windows,
    shift_2d,
)

# the fused block body (norm + FiLM + FFN + conv + residual) runs as one
# block_core call up to this batch, as ffn_block plus a grouped conv above
BLOCK_CORE_MAX_BATCH = 2


class ParamInit:
    """Creates parameters on one device from one torch.Generator: flax's
    lecun_normal (truncated normal, std sqrt(1/fan_in)) and zeros. On the
    meta device it only allocates shapes."""

    # std of a standard normal truncated to [-2, 2]
    _TRUNC_STD = 0.87962566103423978

    def __init__(self, device="cpu", generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator

    def lecun(self, *shape: int, fan_in: int) -> nn.Parameter:
        t = torch.empty(shape, device=self.device)
        if self.device.type != "meta":
            std = math.sqrt(1.0 / fan_in) / self._TRUNC_STD
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=self.generator)
        return nn.Parameter(t)

    def zeros(self, *shape: int) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, device=self.device))


class Dense(nn.Module):
    """x @ kernel + bias over the channel axis (flax nn.Dense)."""

    def __init__(self, din: int, dout: int, init: ParamInit):
        super().__init__()
        self.kernel = init.lecun(din, dout, fan_in=din)
        self.bias = init.zeros(dout)

    def forward(self, x):
        return x @ self.kernel + self.bias


class MultiHeadAttention(nn.Module):
    """MHA with separate biased q/k/v/out projections. Self-attention
    (q_in is kv_in) runs the window_mha kernel wrapper; cross-attention
    runs a plain composition with the same rounding points."""

    def __init__(self, channels: int, num_heads: int, init: ParamInit,
                 kv_channels: Optional[int] = None):
        super().__init__()
        c, ckv = channels, kv_channels or channels
        self.num_heads = num_heads
        self.wq = init.lecun(c, c, fan_in=c)
        self.bq = init.zeros(c)
        self.wk = init.lecun(ckv, c, fan_in=ckv)
        self.bk = init.zeros(c)
        self.wv = init.lecun(ckv, c, fan_in=ckv)
        self.bv = init.zeros(c)
        self.wo = init.lecun(c, c, fan_in=c)
        self.bo = init.zeros(c)

    def forward(self, q_in, kv_in, key_padding_mask=None):
        w = (self.wq, self.bq, self.wk, self.bk, self.wv, self.bv,
             self.wo, self.bo)
        if q_in is kv_in:
            return window_mha(q_in, key_padding_mask, *w,
                              num_heads=self.num_heads)
        b, l, c = q_in.shape
        s = kv_in.shape[1]
        h = self.num_heads
        d = c // h
        dt = q_in.dtype
        proj = lambda x, wt, bs: (x.float() @ wt.float() + bs.float()).to(dt)
        q = proj(q_in, self.wq, self.bq).reshape(b, l, h, d).float()
        k = proj(kv_in, self.wk, self.bk).reshape(b, s, h, d).float()
        v = proj(kv_in, self.wv, self.bv).reshape(b, s, h, d).float()
        scores = torch.einsum("blhd,bshd->bhls", q, k) * (1.0 / math.sqrt(d))
        if key_padding_mask is not None:
            scores = scores + torch.where(
                key_padding_mask[:, None, None, :], NEG_INF, 0.0)
        probs = torch.softmax(scores, dim=-1).to(dt).float()
        o = torch.einsum("bhls,bshd->blhd", probs, v).reshape(b, l, c).to(dt)
        return (o.float() @ self.wo.float() + self.bo.float()).to(dt)


class WindowAttention(nn.Module):
    """Swin-style windowed self-attention over NHWC maps: maps no larger
    than the window attend in full; otherwise pad to window multiples,
    optionally cyclic-shift (rolling the pad mask with the map), attend
    per window with padded keys masked, merge, unshift and crop."""

    def __init__(self, channels: int, num_heads: int, init: ParamInit,
                 window_size: int = 6, shift: int = 0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.mha = MultiHeadAttention(channels, num_heads, init)
        # key-padding masks by (batch, H, W, device): constant per shape
        self._key_masks: dict = {}

    def key_mask(self, b: int, h: int, w: int, device) -> torch.Tensor:
        """[B * nwin, ws * ws] bool, True on padded keys, windows of the
        (shifted) padded map in batch-major order."""
        key = (b, h, w, str(device))
        mask = self._key_masks.get(key)
        if mask is None:
            ws = self.window_size
            hp, wp = h + (-h) % ws, w + (-w) % ws
            mask2d = pad_mask(h, w, hp, wp, device=device)
            if self.shift:
                mask2d = torch.roll(mask2d, (self.shift, self.shift), dims=(0, 1))
            mwin = partition_windows(mask2d[None, :, :, None], ws)[:, :, 0]
            mask = self._key_masks[key] = mwin.repeat(b, 1)
        return mask

    def forward(self, x):
        b, h, w, c = x.shape
        ws = self.window_size
        if h <= ws and w <= ws:
            tokens = x.reshape(b, h * w, c)
            return self.mha(tokens, tokens).reshape(b, h, w, c)
        xp, _, _ = pad_to_window_multiple(x, ws)
        hp, wp = xp.shape[1], xp.shape[2]
        xp = shift_2d(xp, self.shift)
        wins = partition_windows(xp, ws).contiguous()
        out = self.mha(wins, wins,
                       key_padding_mask=self.key_mask(b, h, w, x.device))
        out = merge_windows(out, b, hp, wp, ws)
        if self.shift:
            out = shift_2d(out, -self.shift)
        return out[:, :h, :w, :]


class CrossAttention(nn.Module):
    """Attention of a flattened map against condition tokens. Its
    parameters exist in every attention block (checkpoints are complete);
    unconditioned sampling never calls it."""

    def __init__(self, channels: int, num_heads: int, init: ParamInit,
                 kv_channels: Optional[int] = None):
        super().__init__()
        self.mha = MultiHeadAttention(channels, num_heads, init, kv_channels)

    def forward(self, x, cond):
        b, h, w, c = x.shape
        return self.mha(x.reshape(b, h * w, c), cond).reshape(b, h, w, c)


def pair_table(num_experts: int) -> list:
    """Unordered expert pairs in canonical order: for E=4,
    [(0,1), (0,2), (0,3), (1,2), (1,3), (2,3)]."""
    return [(i, j) for i in range(num_experts) for j in range(i + 1, num_experts)]


class RandomMoE(nn.Module):
    """general(h) + e_i(h) + e_j(h) of ReGLU experts, fused with the
    block's norm and FiLM (and, given conv params, its grouped conv and
    residual). Experts are stacked [E, ...]; the routed pair arrives as
    expert ids [2] int32, a pair id into pair_table, or the configured
    fixed indices."""

    def __init__(self, channels: int, init: ParamInit, ffn_mul: int = 1,
                 num_experts: int = 4,
                 fixed_expert_indices: Optional[Sequence[int]] = None):
        super().__init__()
        c, m, e = channels, channels * ffn_mul, num_experts
        self.wa = init.lecun(e, c, m, fan_in=c)
        self.wb = init.lecun(e, c, m, fan_in=c)
        self.wc = init.lecun(e, m, c, fan_in=m)
        self.ba = init.zeros(e, m)
        self.bb = init.zeros(e, m)
        self.bc = init.zeros(e, c)
        self.gwa = init.lecun(c, m, fan_in=c)
        self.gwb = init.lecun(c, m, fan_in=c)
        self.gwc = init.lecun(m, c, fan_in=m)
        self.gba = init.zeros(m)
        self.gbb = init.zeros(m)
        self.gbc = init.zeros(c)
        self.register_buffer(
            "pairs", torch.tensor(pair_table(e), dtype=torch.int32,
                                  device=init.device), persistent=False)
        fixed = fixed_expert_indices or (0, 0)
        self.register_buffer(
            "fixed_ids", torch.tensor(fixed, dtype=torch.int32,
                                      device=init.device), persistent=False)
        self.has_fixed = fixed_expert_indices is not None

    def expert_ids(self, expert_ids=None, pair_id=None) -> torch.Tensor:
        """The [2] int32 ids this call routes to."""
        if expert_ids is not None:
            return expert_ids
        if pair_id is not None:
            return self.pairs[pair_id]
        if self.has_fixed:
            return self.fixed_ids
        raise ValueError("RandomMoE needs expert_ids, a pair_id or "
                         "fixed_expert_indices (routing is drawn by the UNet)")

    def forward(self, x, film_mul, film_bias, conv_kernel=None,
                conv_bias=None, add_residual: bool = False, expert_ids=None,
                pair_id=None):
        """x: raw block input [B, H, W, C]; film [1 or B, H, W, C].
        Returns (ffn_out, h), or with conv params ([x +] ffn + conv, h)."""
        ids = self.expert_ids(expert_ids, pair_id)
        w = (self.gwa, self.gba, self.gwb, self.gbb, self.gwc, self.gbc,
             self.wa, self.ba, self.wb, self.bb, self.wc, self.bc)
        if conv_kernel is not None:
            return block_core(x, film_mul, film_bias, *w, conv_kernel,
                              conv_bias, ids, add_residual=add_residual)
        c = x.shape[-1]
        out, h = ffn_block(x.reshape(-1, c), film_mul.reshape(-1, c),
                           film_bias.reshape(-1, c), *w, ids)
        return out.reshape(x.shape), h.reshape(x.shape)


class FiLMProj1(nn.Module):
    """First FiLM MLP layer with the concat-matmul factored:
    W1 @ concat(pos, time) == pos @ W1[:C] + time @ W1[C:]."""

    def __init__(self, channels: int, features: int, init: ParamInit):
        super().__init__()
        self.kernel = init.lecun(2 * channels, features, fan_in=2 * channels)
        self.bias = init.zeros(features)

    def forward(self, pos, tim):
        c = pos.shape[-1]
        return pos @ self.kernel[:c] + tim @ self.kernel[c:] + self.bias


class Encodings(nn.Module):
    """FiLM conditioning from positional + time encodings: [pe | te] ->
    2C -> 4C (ReLU) -> 2C, split into (mul, bias)."""

    def __init__(self, channels: int, init: ParamInit):
        super().__init__()
        self.proj1 = FiLMProj1(channels, 4 * channels, init)
        self.proj2 = Dense(4 * channels, 2 * channels, init)

    def film(self, h: int, w: int, t: torch.Tensor):
        """(mul, bias), each [t.shape[0], h, w, C] and contiguous."""
        c = self.proj2.bias.shape[0] // 2
        dt = self.proj2.kernel.dtype
        pe = positional_encoding_2d(h, w, c, dtype=dt, device=t.device)
        te = time_encoding_2d(t, c, dtype=dt)
        embs = self.proj1(pe[None], te)
        embs = embs.expand(t.shape[0], h, w, 4 * c)
        embs = self.proj2(torch.relu(embs))
        mul, bias = embs.chunk(2, dim=-1)
        return mul.contiguous(), bias.contiguous()

    def forward(self, x, t, return_film: bool = False):
        mul, bias = self.film(x.shape[1], x.shape[2], t)
        if return_film:
            return mul, bias
        return x * mul + bias


class GroupedConv2d(nn.Module):
    """3x3 grouped conv, group width min(32, C) (HWIO kernel [3, 3, gw, C])."""

    def __init__(self, channels: int, init: ParamInit, group_width: int = 32):
        super().__init__()
        gw = min(group_width, channels)
        self.kernel = init.lecun(3, 3, gw, channels, fan_in=9 * gw)
        self.bias = init.zeros(channels)

    def forward(self, x):
        return grouped_conv3x3(x, self.kernel, self.bias)


class SwinBlock(nn.Module):
    """ChannelNorm -> FiLM -> (MoE FFN + grouped 3x3 conv [+ window
    attention]) -> + residual. The non-attention body is one block_core
    call at batch <= 2 (residual folded in), ffn_block plus the plain
    grouped conv above."""

    def __init__(self, channels: int, init: ParamInit, head_dim: int = 32,
                 window_size: int = 6, shift: int = 0, attention: bool = True,
                 num_experts: int = 4, ffn_mul: int = 1,
                 fixed_expert_indices: Optional[Sequence[int]] = None):
        super().__init__()
        c = channels
        heads = max(1, c // head_dim)
        self.attention = attention
        self.encodings = Encodings(c, init)
        self.ffn = RandomMoE(c, init, ffn_mul=ffn_mul, num_experts=num_experts,
                             fixed_expert_indices=fixed_expert_indices)
        self.conv = GroupedConv2d(c, init, group_width=min(head_dim, c))
        if attention:
            self.self_attention = WindowAttention(
                c, heads, init, window_size=window_size, shift=shift)
            self.cross_attention = CrossAttention(c, heads, init)

    def forward(self, x, t, film=None, expert_ids=None):
        """film: (mul, bias) replayed from the FiLM schedule, or None to
        run the FiLM tower on t inline; expert_ids: [2] int32 routing, or
        None for the configured fixed indices."""
        mul, bias = film if film is not None else self.encodings(
            x, t, return_film=True)
        # deterministic and unconditioned: the residual always folds
        fused = x.shape[0] <= BLOCK_CORE_MAX_BATCH
        if fused:
            branch, h = self.ffn(x, mul, bias, conv_kernel=self.conv.kernel,
                                 conv_bias=self.conv.bias, add_residual=True,
                                 expert_ids=expert_ids)
        else:
            branch, h = self.ffn(x, mul, bias, expert_ids=expert_ids)
            branch = branch + self.conv(h)
        if self.attention:
            branch = branch + self.self_attention(h)
        return branch if fused else x + branch


class SwinStack(nn.Module):
    """SwinBlocks block_0..block_{n-1}: shift window_size // 2 on even
    blocks, attention (when enabled) on the last two."""

    def __init__(self, channels: int, num_blocks: int, init: ParamInit,
                 head_dim: int = 32, window_size: int = 6,
                 attention: bool = True, num_experts: int = 4,
                 ffn_mul: int = 1,
                 fixed_expert_indices: Optional[Sequence[int]] = None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", SwinBlock(
                channels, init, head_dim=head_dim, window_size=window_size,
                shift=window_size // 2 if i % 2 == 0 else 0,
                attention=attention and i >= num_blocks - 2,
                num_experts=num_experts, ffn_mul=ffn_mul,
                fixed_expert_indices=fixed_expert_indices,
            ))

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_blocks)]

    def forward(self, x, t, film=None, expert_ids=None):
        """film: {block_i: (mul, bias)} or None; expert_ids: [n, 2] int32
        routing rows (None: each block's fixed indices)."""
        for i, block in enumerate(self.blocks()):
            x = block(x, t,
                      film=None if film is None else film[f"block_{i}"],
                      expert_ids=None if expert_ids is None else expert_ids[i])
        return x

    def collect_film(self, h: int, w: int, t: torch.Tensor) -> dict:
        """{block_i: (mul, bias)} of [S, h, w, C] for timesteps t [S]."""
        return {f"block_{i}": b.encodings.film(h, w, t)
                for i, b in enumerate(self.blocks())}

