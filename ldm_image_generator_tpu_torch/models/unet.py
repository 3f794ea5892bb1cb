"""Denoiser UNet (NHWC), the torch counterpart of
ldm_image_generator_tpu/models/unet.py.

Stem (stride-`stem_size` conv) -> encoder SwinStacks with Dense + 2x2
average-pool downsampling between them -> decoder SwinStacks with
nearest 2x upsampling + Dense, additive skips and a zero bottleneck skip
-> un-stem (stride-`stem_size` transposed conv). Attention runs in the
decoder stacks only.

MoE routing: one routing plan per forward, a pair id for every block
(encoder stages in order, then decoder stages from the deepest), either
injected or drawn from an explicit torch.Generator; fixed_expert_indices
pins every block instead.

FiLM schedule: ``collect_film`` evaluates every block's FiLM tower for a
batch of timesteps; ``forward(film=...)`` replays one step's slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ldm_image_generator_tpu_torch.config import UNetConfig, resolve_device
from ldm_image_generator_tpu_torch.models.layers import (
    Dense,
    ParamInit,
    SwinStack,
    pair_table,
)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, NHWC."""
    b, h, w, c = x.shape
    return x[:, : h - h % 2, : w - w % 2].reshape(
        b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


class StrideConv(nn.Module):
    """flax nn.Conv with kernel == stride == s, VALID padding: each s x s
    patch times the kernel [s, s, Cin, Cout]."""

    def __init__(self, cin: int, cout: int, s: int, init: ParamInit):
        super().__init__()
        self.s = s
        self.kernel = init.lecun(s, s, cin, cout, fan_in=s * s * cin)
        self.bias = init.zeros(cout)

    def forward(self, x):
        s = self.s
        b, h, w, c = x.shape
        h, w = h // s, w // s
        patches = x[:, : h * s, : w * s].reshape(b, h, s, w, s, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, h, w, s * s * c)
        return patches @ self.kernel.reshape(s * s * c, -1) + self.bias


class StrideConvTranspose(nn.Module):
    """flax nn.ConvTranspose with kernel == stride == s, VALID padding
    (no kernel transpose): out[s*y + a, s*x + b] = in[y, x] @ K[s-1-a, s-1-b]."""

    def __init__(self, cin: int, cout: int, s: int, init: ParamInit):
        super().__init__()
        self.s = s
        self.kernel = init.lecun(s, s, cin, cout, fan_in=s * s * cin)
        self.bias = init.zeros(cout)

    def forward(self, x):
        s = self.s
        b, h, w, _ = x.shape
        k = self.kernel.flip(0, 1)  # [a, b, Cin, Cout]
        y = torch.einsum("nhwi,abio->nhawbo", x, k)
        return y.reshape(b, h * s, w * s, -1) + self.bias


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if (cfg.num_classes or cfg.experts_per_call != 2
                or cfg.ffn_quant != "none" or cfg.ablate_branches):
            raise NotImplementedError(
                "class conditioning, int8 FFN weights, branch ablation and "
                "routings other than 2-of-E are not ported yet")
        dev = resolve_device(device)
        init = ParamInit(dev, generator)
        self.cfg = cfg
        chs, stages = list(cfg.channels), list(cfg.stages)
        n = len(chs)
        self.encoder_first = StrideConv(cfg.input_channels, chs[0],
                                        cfg.stem_size, init)
        stack = lambda i, attn: SwinStack(
            chs[i], stages[i], init, head_dim=cfg.head_dim,
            window_size=cfg.window_size, attention=attn,
            num_experts=cfg.num_experts, ffn_mul=cfg.ffn_mul,
            fixed_expert_indices=cfg.fixed_expert_indices)
        for i in range(n):
            self.add_module(f"enc_stage_{i}", stack(i, False))
            if i != n - 1:
                self.add_module(f"enc_chconv_{i}", Dense(chs[i], chs[i + 1], init))
        for i in reversed(range(n)):
            if i != n - 1:
                self.add_module(f"dec_chconv_{i}", Dense(chs[i + 1], chs[i], init))
            self.add_module(f"dec_stage_{i}", stack(i, True))
        self.decoder_last = StrideConvTranspose(chs[0], cfg.input_channels,
                                                cfg.stem_size, init)
        self.register_buffer(
            "pairs", torch.tensor(pair_table(cfg.num_experts),
                                  dtype=torch.int32, device=dev),
            persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder_first.kernel.dtype

    def stage_names(self) -> list:
        """Stack names in routing-plan order."""
        n = len(self.cfg.channels)
        return ([f"enc_stage_{i}" for i in range(n)]
                + [f"dec_stage_{i}" for i in reversed(range(n))])

    def plan_length(self) -> int:
        return 2 * sum(self.cfg.stages)

    def routing(self, moe_plan=None, generator=None) -> Optional[dict]:
        """{stage: [n_blocks, 2] int32 expert ids} from an injected plan of
        pair ids or one drawn from `generator`; None when the config pins
        fixed_expert_indices."""
        if self.cfg.fixed_expert_indices is not None:
            return None
        if moe_plan is None:
            if generator is None:
                raise ValueError("UNet routing needs moe_plan or a generator")
            n_pairs = self.pairs.shape[0]
            moe_plan = torch.randint(0, n_pairs, (self.plan_length(),),
                                     generator=generator,
                                     device=self.pairs.device)
        ids = self.pairs[moe_plan.to(self.pairs.device).long()]
        out, off = {}, 0
        for name in self.stage_names():
            nb = getattr(self, name).num_blocks
            out[name] = ids[off:off + nb]
            off += nb
        return out

    def collect_film(self, t: torch.Tensor, latent_hw) -> dict:
        """{stage: {block: (mul, bias)}} of [S, h, w, c] tensors for the
        timesteps t [S] at a latent of spatial size latent_hw (h, w)."""
        s = self.cfg.stem_size
        h, w = latent_hw[0] // s, latent_hw[1] // s
        films = {}
        for i in range(len(self.cfg.channels)):
            hi, wi = h >> i, w >> i
            for name in (f"enc_stage_{i}", f"dec_stage_{i}"):
                films[name] = getattr(self, name).collect_film(hi, wi, t)
        return films

    def forward(self, x, t, film=None, moe_plan=None, generator=None):
        """x [B, H, W, Cin]; t [1 or B] timesteps; film: one step's
        {stage: {block: (mul, bias)}} or None for inline FiLM."""
        n = len(self.cfg.channels)
        routes = self.routing(moe_plan, generator)
        run = lambda name, x: getattr(self, name)(
            x, t, film=None if film is None else film[name],
            expert_ids=None if routes is None else routes[name])
        x = self.encoder_first(x.to(self.dtype))
        skips = []
        for i in range(n):
            x = run(f"enc_stage_{i}", x)
            if i == n - 1:
                skips.append(None)  # zero bottleneck skip
            else:
                skips.append(x)
                x = avg_pool_2x(getattr(self, f"enc_chconv_{i}")(x))
        for i in reversed(range(n)):
            if i != n - 1:
                x = getattr(self, f"dec_chconv_{i}")(upsample_nearest_2x(x))
            if skips[i] is not None:
                x = x + skips[i]
            x = run(f"dec_stage_{i}", x)
        return self.decoder_last(x)

