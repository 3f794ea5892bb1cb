"""SwinBlock building blocks (NHWC), torch counterparts of
ldm_image_generator_tpu/models/layers.py.

Parameter names and shapes follow the flax tree (Dense kernels [in, out],
HWIO convs, stacked experts [E, C, M]), so convert.py carries a JAX
checkpoint across by flattening names. Modules compute in the dtype of
the activations they receive and cast each parameter to it at use, as
flax's `dtype` field does: training keeps fp32 parameters and computes
in bf16 (the cast's gradient reaches the fp32 parameter); the sampling
pipeline casts copies of the modules once, so there the cast is a no-op.
With int8 FFN weights (RandomMoE quant='int8') each block quantizes its
cast FFN weights once per weight version and keeps them; training
through them is straight-through to the parameters.

The block body runs through the port's kernel wrappers: block_core at
batch <= 2, ffn_block plus a plain grouped conv above, and window_mha for
the attention blocks. Each wrapper takes its plain version for CPU
tensors and its CUDA kernel for CUDA tensors. A block with a branch of
norm, FiLM or the MoE ablated, or with k != 2 experts per call, runs the
plain composition on every device instead (SwinBlock), as the JAX
package leaves those to XLA.

Randomness is explicit: MoE routing arrives as expert ids (from the
UNet's routing plan, a pair id, or fixed indices), and the
stochastic-depth gate of a training forward as a 0/1 tensor per block
(from the UNet). The gate multiplies the block's branch, as the JAX
package does, so a skipped block still launches its kernels.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
from torch import nn

from ldm_image_generator_tpu_torch.kernels.block_core import (
    block_core,
    grouped_conv3x3,
)
from ldm_image_generator_tpu_torch.kernels.ffn_block import (
    dequantize_ffn,
    ffn_block,
    quantize_ffn,
)
from ldm_image_generator_tpu_torch.kernels.window_attention import (
    NEG_INF,
    window_mha,
)
from ldm_image_generator_tpu_torch.ops.norm import channel_norm
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


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in dtype (differentiable); t itself when it already is, without
    the cost of a .to() call on the sampling path's hot loop."""
    return t if t.dtype == dtype else t.to(dtype)


def cast_all(ts: tuple, dtype: torch.dtype) -> tuple:
    """The tensors ts, which share one dtype (a module's parameters), in
    dtype: one comparison per call when they already are (the sampling
    pipeline casts its modules once), where a cast of each costs ~0.2 us
    of host time per tensor on a host-bound path."""
    return ts if ts[0].dtype == dtype else tuple(t.to(dtype) for t in ts)


class ParamInit:
    """Creates parameters on one device from one torch.Generator: flax's
    lecun_normal (truncated normal, std sqrt(1/fan_in)), zeros and normal.
    On the meta device it only allocates shapes."""

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

    def normal(self, *shape: int, std: float = 1.0) -> nn.Parameter:
        t = torch.empty(shape, device=self.device)
        if self.device.type != "meta":
            nn.init.normal_(t, 0.0, std, generator=self.generator)
        return nn.Parameter(t)


class Dense(nn.Module):
    """x @ kernel + bias over the channel axis (flax nn.Dense)."""

    def __init__(self, din: int, dout: int, init: ParamInit):
        super().__init__()
        self.kernel = init.lecun(din, dout, fan_in=din)
        self.bias = init.zeros(dout)

    def forward(self, x):
        return x @ cast(self.kernel, x.dtype) + cast(self.bias, x.dtype)


class MultiHeadAttention(nn.Module):
    """MHA with separate biased q/k/v/out projections. Self-attention
    (q_in is kv_in) runs the window_mha kernel wrapper; cross-attention
    runs a plain composition with the same rounding points, its k/v
    projections [kv_channels, C] (the condition tokens' width)."""

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
        w = cast_all((self.wq, self.bq, self.wk, self.bk, self.wv, self.bv,
                      self.wo, self.bo), q_in.dtype)
        if q_in is kv_in:
            return window_mha(q_in, key_padding_mask, *w,
                              num_heads=self.num_heads)
        kv_in = cast(kv_in, q_in.dtype)
        b, l, c = q_in.shape
        s = kv_in.shape[1]
        h = self.num_heads
        d = c // h
        dt = q_in.dtype
        wq, bq, wk, bk, wv, bv, wo, bo = w
        proj = lambda x, wt, bs: (x.float() @ wt.float() + bs.float()).to(dt)
        q = proj(q_in, wq, bq).reshape(b, l, h, d).float()
        k = proj(kv_in, wk, bk).reshape(b, s, h, d).float()
        v = proj(kv_in, wv, bv).reshape(b, s, h, d).float()
        scores = torch.einsum("blhd,bshd->bhls", q, k) * (1.0 / math.sqrt(d))
        if key_padding_mask is not None:
            scores = scores + torch.where(
                key_padding_mask[:, None, None, :], NEG_INF, 0.0)
        probs = torch.softmax(scores, dim=-1).to(dt).float()
        o = torch.einsum("bhls,bshd->blhd", probs, v).reshape(b, l, c).to(dt)
        return (o.float() @ wo.float() + bo.float()).to(dt)


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
    """Attention of a flattened map against condition tokens [B, T,
    kv_channels]. Its parameters exist in every attention block
    (checkpoints are complete); an unconditioned forward never calls it."""

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
    fixed indices. ``plain`` is the unfused route on an already
    normalized and FiLMed h, for any number k of routed experts.

    quant='int8' runs the kernels' int8 routes. The weights are cast to
    the compute dtype and then quantized (quantize_cols), as the JAX
    package's fused TPU route does; its CPU route quantizes the fp32
    parameters and casts after, so in bf16 a scale may differ from it by
    a bf16 rounding (fp32 compute is the same either way). The int8
    weights are made under no_grad once per weight version and kept, so
    a remat recompute reuses them; with grad mode on the wrappers also
    take the cast weights, attached to the graph, and the dequantized
    copies (kept beside the int8 ones): the backward runs at those and
    its weight gradients pass straight through to the parameters (the
    JAX package's fake_quantize). An optimizer step changes every
    version, so a train step quantizes each of a block's 6 matrices once."""

    def __init__(self, channels: int, init: ParamInit, ffn_mul: int = 1,
                 num_experts: int = 4,
                 fixed_expert_indices: Optional[Sequence[int]] = None,
                 quant: str = "none"):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"ffn quant {quant!r}: 'none' or 'int8'")
        self.quant = quant
        # (weight version, int8 weights) of the last quantization
        self._int8 = None
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
        """The [k] int32 ids this call routes to (a pair id: k = 2)."""
        if expert_ids is not None:
            return expert_ids
        if pair_id is not None:
            return self.pairs[pair_id]
        if self.has_fixed:
            return self.fixed_ids
        raise ValueError("RandomMoE needs expert_ids, a pair_id or "
                         "fixed_expert_indices (routing is drawn by the UNet)")

    def ffn_weights(self, dtype: torch.dtype, dequantized: bool = False):
        """(w, int8): w the 12 FFN weights cast to the compute dtype (the
        parameters themselves when they are in it); int8 None, or with
        quant='int8' (their int8 forms, their dequantized copies in dtype
        when `dequantized` or made before, else None), made once per
        weight version (a parameter's storage and in-place version) and
        kept. With quant='int8' and grad mode off, w is None: the int8
        forms are all a forward needs, and a kept copy costs no cast."""
        params = (self.gwa, self.gba, self.gwb, self.gbb, self.gwc, self.gbc,
                  self.wa, self.ba, self.wb, self.bb, self.wc, self.bc)
        if self.quant == "none":
            return cast_all(params, dtype), None
        w = cast_all(params, dtype) if torch.is_grad_enabled() else None
        key = (dtype,) + tuple((t.data_ptr(), t._version) for t in params)
        if self._int8 is None or self._int8[0] != key:
            with torch.no_grad():
                made = quantize_ffn(cast_all(params, dtype) if w is None else w)
            self._int8 = [key, made, None]
        if dequantized and self._int8[2] is None:
            self._int8[2] = dequantize_ffn(self._int8[1], dtype)
        return w, tuple(self._int8[1:])

    def forward(self, x, film_mul, film_bias, conv_kernel=None,
                conv_bias=None, add_residual: bool = False, expert_ids=None,
                pair_id=None):
        """x: raw block input [B, H, W, C]; film [1 or B, H, W, C].
        Returns (ffn_out, h), or with conv params ([x +] ffn + conv, h).
        Parameters, film and conv params are cast to x.dtype."""
        ids = self.expert_ids(expert_ids, pair_id)
        dt = x.dtype
        w, int8 = self.ffn_weights(dt, dequantized=torch.is_grad_enabled())
        if w is None:  # int8 without grad mode: the kernels take the int8 forms
            w, int8 = int8[0], None
        film_mul, film_bias = cast_all((film_mul, film_bias), dt)
        if conv_kernel is not None:
            conv_kernel, conv_bias = cast_all((conv_kernel, conv_bias), dt)
            return block_core(x, film_mul, film_bias, *w, conv_kernel,
                              conv_bias, ids, add_residual=add_residual, int8=int8)
        c = x.shape[-1]
        out, h = ffn_block(x.reshape(-1, c), film_mul.reshape(-1, c),
                           film_bias.reshape(-1, c), *w, ids, int8=int8)
        return out.reshape(x.shape), h.reshape(x.shape)

    def plain(self, h, expert_ids=None, pair_id=None):
        """general(h) + the sum of the routed experts of h [B, H, W, C], in
        h's dtype (the JAX package's unfused XLA route): the k experts
        gathered from the stacked weights, their products as einsums, the
        sum of their output biases. With quant='int8' on the dequantized
        weights, with straight-through gradients (fake_quantize)."""
        ids = self.expert_ids(expert_ids, pair_id).long()
        w, int8 = self.ffn_weights(h.dtype, dequantized=True)
        if int8 is not None:
            w = int8[1] if w is None else tuple(a + (b - a).detach()
                                                for a, b in zip(w, int8[1]))
        gwa, gba, gwb, gbb, gwc, gbc, wa, ba, wb, bb, wc, bc = w
        out = ((h @ gwa + gba) * torch.relu(h @ gwb + gbb)) @ gwc + gbc
        row = lambda b: b[ids][:, None, None, None, :]
        xa = torch.einsum("bhwc,kcm->kbhwm", h, wa[ids]) + row(ba)
        xb = torch.einsum("bhwc,kcm->kbhwm", h, wb[ids]) + row(bb)
        experts = torch.einsum("kbhwm,kmc->bhwc", xa * torch.relu(xb), wc[ids])
        return out + (experts + bc[ids].sum(0))


class FiLMProj1(nn.Module):
    """First FiLM MLP layer with the concat-matmul factored:
    W1 @ concat(pos, time) == pos @ W1[:C] + time @ W1[C:]."""

    def __init__(self, channels: int, features: int, init: ParamInit):
        super().__init__()
        self.kernel = init.lecun(2 * channels, features, fan_in=2 * channels)
        self.bias = init.zeros(features)

    def forward(self, pos, tim):
        c = pos.shape[-1]
        k = cast(self.kernel, pos.dtype)
        return pos @ k[:c] + tim @ k[c:] + cast(self.bias, pos.dtype)


class Encodings(nn.Module):
    """FiLM conditioning from positional + time encodings: [pe | te] ->
    2C -> 4C (ReLU) -> 2C, split into (mul, bias)."""

    def __init__(self, channels: int, init: ParamInit):
        super().__init__()
        self.proj1 = FiLMProj1(channels, 4 * channels, init)
        self.proj2 = Dense(4 * channels, 2 * channels, init)

    def film(self, h: int, w: int, t: torch.Tensor, dtype=None, rows=None):
        """(mul, bias), each [t.shape[0], h, w, C] and contiguous, in
        `dtype` (default: the parameters'). rows: (first row, map height)
        when the h rows are a stripe of a taller map (a spatial split):
        the positions are the stripe's in the whole map."""
        c = self.proj2.bias.shape[0] // 2
        dt = dtype or self.proj2.kernel.dtype
        if rows is None:
            pe = positional_encoding_2d(h, w, c, dtype=dt, device=t.device)
        else:
            pe = positional_encoding_2d(rows[1], w, c, dtype=dt,
                                        device=t.device)[rows[0]:rows[0] + h]
        te = time_encoding_2d(t, c, dtype=dt)
        embs = self.proj1(pe[None], te)
        embs = embs.expand(t.shape[0], h, w, 4 * c)
        embs = self.proj2(torch.relu(embs))
        mul, bias = embs.chunk(2, dim=-1)
        return mul.contiguous(), bias.contiguous()

    def forward(self, x, t, return_film: bool = False, rows=None):
        mul, bias = self.film(x.shape[1], x.shape[2], t, dtype=x.dtype, rows=rows)
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
        return grouped_conv3x3(x, cast(self.kernel, x.dtype), cast(self.bias, x.dtype))


class SwinBlock(nn.Module):
    """ChannelNorm -> FiLM -> (MoE FFN + grouped 3x3 conv [+ window
    attention][+ cross attention on the summed branch]) -> [x
    stochastic-depth gate] -> + residual. The non-attention body is one
    block_core call at batch <= 2, ffn_block plus the plain grouped conv
    above. block_core folds the residual in only where nothing follows
    on the branch: no gate and no condition (the JAX package's
    fold_res), since the fold rounds at another point. cond_channels:
    the condition tokens' width (0: an unconditioned model, whose
    cross-attention params stay square).

    experts_per_call k and ablate_branches (names of 'norm', 'film',
    'moe', 'conv', 'attn' to skip; a debugging and profiling aid) follow
    the JAX package's rules: the kernels take the block only with norm,
    film and moe on and k == 2 (block_core needs conv on as well);
    otherwise it runs the plain composition, as the JAX package leaves it
    to XLA: h = channel_norm(x) (x itself with norm skipped), times the
    FiLM scale plus its shift (skipped with film), the plain MoE of k
    experts (a zero branch with moe skipped), then the conv and the
    attention where they are on. Parameters exist whatever is skipped,
    and the routing and stochastic-depth draws are the UNet's, so their
    count and order do not change either."""

    BRANCHES = ("norm", "film", "moe", "conv", "attn")

    def __init__(self, channels: int, init: ParamInit, head_dim: int = 32,
                 window_size: int = 6, shift: int = 0, attention: bool = True,
                 num_experts: int = 4, ffn_mul: int = 1,
                 fixed_expert_indices: Optional[Sequence[int]] = None,
                 ffn_quant: str = "none", cond_channels: int = 0,
                 experts_per_call: int = 2,
                 ablate_branches: Optional[Sequence[str]] = None):
        super().__init__()
        c = channels
        heads = max(1, c // head_dim)
        self.attention = attention
        self.skip = frozenset(ablate_branches or ())
        unknown = self.skip - set(self.BRANCHES)
        if unknown:
            raise ValueError(f"ablate_branches {sorted(unknown)}: not among "
                             f"{self.BRANCHES}")
        self.fused = not self.skip & {"norm", "film", "moe"} and experts_per_call == 2
        self.encodings = Encodings(c, init)
        self.ffn = RandomMoE(c, init, ffn_mul=ffn_mul, num_experts=num_experts,
                             fixed_expert_indices=fixed_expert_indices,
                             quant=ffn_quant)
        self.conv = GroupedConv2d(c, init, group_width=min(head_dim, c))
        if attention:
            self.self_attention = WindowAttention(
                c, heads, init, window_size=window_size, shift=shift)
            self.cross_attention = CrossAttention(c, heads, init,
                                                  kv_channels=cond_channels or None)

    def forward(self, x, t, film=None, expert_ids=None, gate=None, cond=None,
                spatial=None):
        """film: (mul, bias) replayed from the FiLM schedule, or None to
        run the FiLM tower on t inline; expert_ids: [k] int32 routing, or
        None for the configured fixed indices; gate: the stochastic-depth
        keep (a 0/1 or bool scalar tensor) of a training forward, or None;
        cond: condition tokens [B, T, D] (a decoder stack's blocks of a
        conditioned forward), or None; spatial: a parallel.mesh.SpatialSplit
        when x is this rank's rows of the map (the FiLM tower at the rows'
        positions, the grouped conv on a one-row halo, window attention on
        the gathered map; the body takes ffn_block plus the conv, not
        block_core, whose fused conv has no halo), or None."""
        skip = self.skip
        fused_conv = (self.fused and "conv" not in skip and spatial is None
                      and x.shape[0] <= BLOCK_CORE_MAX_BATCH)
        fold = fused_conv and gate is None and cond is None
        rows = None if spatial is None else spatial.rows(x.shape[1])
        if self.fused:
            mul, bias = film if film is not None else self.encodings(
                x, t, return_film=True, rows=rows)
            if fused_conv:
                branch, h = self.ffn(x, mul, bias, conv_kernel=self.conv.kernel,
                                     conv_bias=self.conv.bias, add_residual=fold,
                                     expert_ids=expert_ids)
            else:
                branch, h = self.ffn(x, mul, bias, expert_ids=expert_ids)
        else:
            h = x if "norm" in skip else channel_norm(x)
            if "film" not in skip:
                mul, bias = film if film is not None else self.encodings(
                    h, t, return_film=True, rows=rows)
                h = h * cast(mul, h.dtype) + cast(bias, h.dtype)
            branch = (torch.zeros_like(h) if "moe" in skip
                      else self.ffn.plain(h, expert_ids))
        if not fused_conv and "conv" not in skip:
            if spatial is None:
                branch = branch + self.conv(h)
            else:
                branch = branch + self.conv(spatial.halo(h))[:, 1:-1]
        if self.attention:
            if "attn" not in skip and spatial is None:
                branch = branch + self.self_attention(h)
            elif "attn" not in skip:
                branch = branch + spatial.own(self.self_attention(spatial.gather(h)))
            if cond is not None:
                branch = branch + self.cross_attention(branch, cond)
        if gate is not None:
            branch = branch * gate.to(branch.dtype)
        return branch if fold else x + branch


def _run_on(device: torch.device, block: nn.Module, x, t, kw: dict):
    """block(x, t, **kw) with every tensor moved to `device`, which is
    current while the block launches."""
    move = lambda v: v.to(device) if isinstance(v, torch.Tensor) else (
        tuple(move(u) for u in v) if isinstance(v, tuple) else v)
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        return block(move(x), move(t), **{k: move(v) for k, v in kw.items()})


class SwinStack(nn.Module):
    """SwinBlocks block_0..block_{n-1}: shift window_size // 2 on even
    blocks, attention (when enabled) on the last two."""

    def __init__(self, channels: int, num_blocks: int, init: ParamInit,
                 head_dim: int = 32, window_size: int = 6,
                 attention: bool = True, num_experts: int = 4,
                 ffn_mul: int = 1,
                 fixed_expert_indices: Optional[Sequence[int]] = None,
                 ffn_quant: str = "none", cond_channels: int = 0,
                 experts_per_call: int = 2,
                 ablate_branches: Optional[Sequence[str]] = None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", SwinBlock(
                channels, init, head_dim=head_dim, window_size=window_size,
                shift=window_size // 2 if i % 2 == 0 else 0,
                attention=attention and i >= num_blocks - 2,
                num_experts=num_experts, ffn_mul=ffn_mul,
                fixed_expert_indices=fixed_expert_indices,
                ffn_quant=ffn_quant, cond_channels=cond_channels,
                experts_per_call=experts_per_call,
                ablate_branches=ablate_branches,
            ))

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_blocks)]

    def forward(self, x, t, film=None, expert_ids=None, gates=None, cond=None,
                spatial=None):
        """film: {block_i: (mul, bias)} or None; expert_ids: [n, k] int32
        routing rows (None: each block's fixed indices); gates: [n]
        stochastic-depth keeps, or None (deterministic); cond: condition
        tokens for every block, or None; spatial: the blocks' spatial
        split (SwinBlock), or None."""
        home = x.device
        for i, block in enumerate(self.blocks()):
            kw = dict(film=None if film is None else film[f"block_{i}"],
                      expert_ids=None if expert_ids is None else expert_ids[i],
                      gate=None if gates is None else gates[i], cond=cond,
                      spatial=spatial)
            dev = block.conv.bias.device
            if dev == x.device:
                x = block(x, t, **kw)
            else:  # a pipelined UNet's blocks span cards (parallel/pipelined_unet.py)
                x = _run_on(dev, block, x, t, kw)
        return x.to(home)

    def collect_film(self, h: int, w: int, t: torch.Tensor) -> dict:
        """{block_i: (mul, bias)} of [S, h, w, C] for timesteps t [S]."""
        return {f"block_{i}": b.encodings.film(h, w, t)
                for i, b in enumerate(self.blocks())}

