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
pins every block instead. With experts_per_call k != 2 the plan is k
distinct expert ids per block ([plan_length, k], drawn without
replacement, as the JAX package's per-block jax.random.choice), and the
blocks take the plain MoE route (the kernels read two expert ids). A
training forward (deterministic=False) also takes one stochastic-depth
keep per block in the same layout, injected (`sd_gates`) or drawn from
the generator as u > p.

Compute dtype: `forward(dtype=...)` casts the input, and every module
casts its parameters at use to the activations' dtype, so fp32
parameters train in bf16 compute; by default the parameters' dtype.

FiLM schedule: ``collect_film`` evaluates every block's FiLM tower for a
batch of timesteps; ``forward(film=...)`` replays one step's slice.

Class conditioning (num_classes > 0): integer class ids [B] are embedded
(``class_embed``, row num_classes the learned null class of CFG) into
cond_tokens tokens of cond_channels; prebuilt tokens [B, T, D] pass
through. The condition reaches every decoder block: cross-attention in
the attention blocks, and no block folds its residual into block_core.

DeepCache (``with_deep`` / ``deep``, as the JAX package's UNet): the deep
core is everything between enc_stage_0 and the output of dec_chconv_0;
``with_deep=True`` also returns that output, and ``deep=`` a previous
one runs only enc_stage_0, the add and dec_stage_0 in its place. The
routing plan is drawn at full length either way, so those two stages
route as the full forward would under the same plan.

remat (``remat=True``, as the JAX package's ``nn.remat`` per stack): each
SwinStack of a forward with grad mode on runs under
``torch.utils.checkpoint`` (non-reentrant), keeping only its input and
recomputing its activations in the backward; the kernels launch again
for the recompute. The routing plan and the stochastic-depth gates are
drawn before any stack runs, so no draw is repeated (checkpoint restores
the global RNG, not an explicit generator). ``collect_film`` (FiLM towers
only) is not rematerialized.

int8 FFN weights (``ffn_quant='int8'``, as the JAX package's UNetConfig):
every block's MoE FFN runs the kernels' int8 routes; a training forward
takes the backward at the dequantized weights with straight-through
gradients to the fp32 parameters (layers.RandomMoE); ``prepare`` makes
the int8 weights ahead of a sampling run.

ablate_branches (SwinBlock branch names to skip; parameters are still
created, so files and trees are unchanged) reaches every block.

Spatial parallelism (``spatial``, set by parallel/mesh.py
spatial_parallel; None by default): the forward takes this rank's rows
of the input's height and returns its rows of the output; the blocks
exchange what crosses rows (SwinBlock), and a split that leaves a stage
an odd or empty stripe before its 2x downsampling is refused.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ldm_image_generator_tpu_torch.config import UNetConfig, resolve_device
from ldm_image_generator_tpu_torch.models.layers import (
    Dense,
    ParamInit,
    RandomMoE,
    SwinStack,
    cast,
    pair_table,
)


def refusal(cfg: UNetConfig):
    """The message refusing a config field this port would otherwise
    accept and ignore, or None."""
    todo = [
        (cfg.ffn_backend not in ("auto", "pallas"),
         f"ffn_backend={cfg.ffn_backend!r} (the JAX package's XLA "
         "composition, which rounds bf16 at other points than the kernels)"),
        (cfg.attention_backend not in ("auto", "pallas"),
         f"attention_backend={cfg.attention_backend!r} (the JAX package's "
         "XLA composition)"),
    ]
    hits = [what for hit, what in todo if hit]
    return "not ported yet: " + "; ".join(hits) if hits else None


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
        k = cast(self.kernel, x.dtype).reshape(s * s * c, -1)
        return patches @ k + cast(self.bias, x.dtype)


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
        k = cast(self.kernel, x.dtype).flip(0, 1)  # [a, b, Cin, Cout]
        y = torch.einsum("nhwi,abio->nhawbo", x, k)
        return y.reshape(b, h * s, w * s, -1) + cast(self.bias, x.dtype)


class ClassEmbed(nn.Module):
    """flax nn.Embed: a table [num_classes + 1, cond_channels *
    cond_tokens], normal init with std 1 / sqrt(features)."""

    def __init__(self, rows: int, features: int, init: ParamInit):
        super().__init__()
        self.embedding = init.normal(rows, features, std=features ** -0.5)


class UNet(nn.Module):
    """What LDMPipeline asks of a denoiser (models/dit.py's DiT answers the
    same): cfg.input_channels and cfg.num_classes, prepare(dtype),
    draw_fn(generator), tokens(latent) and takes_film."""

    # the pipeline hands each call one step's slice of its FiLM memo, the
    # step's routing plan and DeepCache's deep features
    takes_film = True

    def __init__(self, cfg: UNetConfig = UNetConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        why = refusal(cfg)
        if why:
            raise NotImplementedError(f"UNetConfig: {why} (see ROADMAP.md)")
        if not 1 <= cfg.experts_per_call <= cfg.num_experts:
            raise ValueError(f"experts_per_call {cfg.experts_per_call}: 1 to "
                             f"num_experts ({cfg.num_experts})")
        dev = resolve_device(device)
        init = ParamInit(dev, generator)
        self.cfg = cfg
        chs, stages = list(cfg.channels), list(cfg.stages)
        n = len(chs)
        if cfg.num_classes > 0:
            self.class_embed = ClassEmbed(cfg.num_classes + 1,
                                          cfg.cond_channels * cfg.cond_tokens, init)
        self.encoder_first = StrideConv(cfg.input_channels, chs[0],
                                        cfg.stem_size, init)
        stack = lambda i, attn: SwinStack(
            chs[i], stages[i], init, head_dim=cfg.head_dim,
            window_size=cfg.window_size, attention=attn,
            num_experts=cfg.num_experts, ffn_mul=cfg.ffn_mul,
            fixed_expert_indices=cfg.fixed_expert_indices,
            ffn_quant=cfg.ffn_quant,
            cond_channels=cfg.cond_channels if cfg.num_classes else 0,
            experts_per_call=cfg.experts_per_call,
            ablate_branches=cfg.ablate_branches)
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
        # a parallel.mesh.SpatialSplit, or None (the whole map)
        self.spatial = None

    @property
    def dtype(self) -> torch.dtype:
        return self.encoder_first.kernel.dtype

    def prepare(self, dtype: torch.dtype) -> None:
        """Make every block's FFN weights for compute dtype now: with
        ffn_quant='int8' the int8 weights a forward would otherwise make
        at its first call (a no-op otherwise)."""
        if self.cfg.ffn_quant == "int8":
            for m in self.modules():
                if isinstance(m, RandomMoE):
                    m.ffn_weights(dtype)

    def draw_fn(self, generator: Optional[torch.Generator]):
        """draw() -> one step's routing plan from `generator`, or None
        when the config fixes the experts."""
        if self.cfg.fixed_expert_indices is not None:
            return lambda: None
        if generator is None:
            raise ValueError("sampling with drawn MoE routing needs a generator")
        return lambda: self.draw_plan(generator)

    def tokens(self, latent: int) -> int:
        """Tokens per row at a latent of side `latent` (the stem's map)."""
        return (latent // self.cfg.stem_size) ** 2

    def stage_names(self) -> list:
        """Stack names in routing-plan order."""
        n = len(self.cfg.channels)
        return ([f"enc_stage_{i}" for i in range(n)]
                + [f"dec_stage_{i}" for i in reversed(range(n))])

    def plan_length(self) -> int:
        return 2 * sum(self.cfg.stages)

    def _per_stage(self, rows) -> dict:
        """{stage: rows[off:off + n_blocks]} in routing-plan order."""
        out, off = {}, 0
        for name in self.stage_names():
            nb = getattr(self, name).num_blocks
            out[name] = rows[off:off + nb]
            off += nb
        return out

    def draw_plan(self, generator: torch.Generator) -> torch.Tensor:
        """One routing plan from `generator` (on the UNet's device):
        [plan_length] pair ids, uniform; with experts_per_call k != 2,
        [plan_length, k] int32 expert ids, k distinct per block, uniform
        without replacement."""
        cfg, n, dev = self.cfg, self.plan_length(), self.pairs.device
        if cfg.experts_per_call == 2:
            return torch.randint(0, self.pairs.shape[0], (n,),
                                 generator=generator, device=dev)
        u = torch.rand((n, cfg.num_experts), generator=generator, device=dev)
        return u.argsort(dim=-1)[:, :cfg.experts_per_call].to(torch.int32)

    def routing(self, moe_plan=None, generator=None) -> Optional[dict]:
        """{stage: [n_blocks, k] int32 expert ids} from an injected plan
        (see draw_plan) or one drawn from `generator`; None when the
        config pins fixed_expert_indices."""
        if self.cfg.fixed_expert_indices is not None:
            return None
        if moe_plan is None:
            if generator is None:
                raise ValueError("UNet routing needs moe_plan or a generator")
            moe_plan = self.draw_plan(generator)
        moe_plan = moe_plan.to(self.pairs.device)
        if self.cfg.experts_per_call == 2:
            return self._per_stage(self.pairs[moe_plan.long()])
        return self._per_stage(moe_plan.to(torch.int32))

    def sd_gates(self, sd_gates=None, generator=None) -> Optional[dict]:
        """{stage: [n_blocks] bool keeps} of a training forward, injected
        or drawn from `generator` (u > stochastic_depth, one uniform per
        block, shared by the batch); None when stochastic_depth is 0."""
        p = self.cfg.stochastic_depth
        if p == 0.0:
            return None
        if sd_gates is None:
            if generator is None:
                raise ValueError("stochastic depth needs sd_gates or a generator")
            u = torch.rand((self.plan_length(),), generator=generator,
                           device=self.pairs.device)
            sd_gates = u > p
        return self._per_stage(sd_gates.to(self.pairs.device))

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

    def condition_tokens(self, condition, dtype) -> Optional[torch.Tensor]:
        """[B, cond_tokens, cond_channels] in dtype for integer class ids
        [B] (id num_classes: the null class); prebuilt tokens pass
        through; None stays None."""
        if condition is None or condition.is_floating_point():
            return condition
        cfg = self.cfg
        if cfg.num_classes <= 0:
            raise ValueError("integer class ids need a UNet with num_classes > 0")
        table = cast(self.class_embed.embedding, dtype)
        ids = condition.to(device=table.device, dtype=torch.long)
        return table[ids].reshape(ids.shape[0], cfg.cond_tokens, cfg.cond_channels)

    def forward(self, x, t, condition=None, film=None, moe_plan=None,
                generator=None, sd_gates=None, deterministic: bool = True,
                dtype=None, deep=None, with_deep: bool = False):
        """x [B, H, W, Cin]; t [1 or B] timesteps; condition: class ids
        [B] or tokens [B, T, D] for the decoder stacks, or None; film: one
        step's {stage: {block: (mul, bias)}} or None for inline FiLM.
        deterministic=False is a training forward: stochastic-depth gates
        (`sd_gates` [plan_length] bool, or drawn from `generator`) gate
        each block's branch. dtype: the compute dtype (default: the
        parameters'); the output is in it. with_deep: also return the
        deep-core output; deep: a previous step's, reused in place of the
        deep core (DeepCache)."""
        n = len(self.cfg.channels)
        dt = dtype or self.dtype
        routes = self.routing(moe_plan, generator)
        gates = None if deterministic else self.sd_gates(sd_gates, generator)
        cond = self.condition_tokens(condition, dt)
        remat = self.cfg.remat and torch.is_grad_enabled()
        sp = self.spatial
        if sp is not None:
            sp.check(x.shape[1], self.cfg.stem_size, n)

        def run(name, x):
            kwargs = dict(film=None if film is None else film[name],
                          expert_ids=None if routes is None else routes[name],
                          gates=None if gates is None else gates[name],
                          cond=cond if name.startswith("dec") else None,
                          spatial=sp)
            stack = getattr(self, name)
            if remat:
                # every draw (routing, gates) was made above: the recompute
                # replays the stack on the same ids and gates
                return checkpoint(stack, x, t, use_reentrant=False, **kwargs)
            return stack(x, t, **kwargs)

        x = self.encoder_first(x.to(dt))
        deep_out = None
        if deep is not None:
            if n < 2:
                raise ValueError("deep-feature reuse needs a UNet with >= 2 stages")
            x = run("enc_stage_0", x)
            deep_out = deep.to(dt)
            x = run("dec_stage_0", deep_out + x)
        else:
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
                if i == 0 and n >= 2:
                    deep_out = x  # the deep core's output
                if skips[i] is not None:
                    x = x + skips[i]
                x = run(f"dec_stage_{i}", x)
        out = self.decoder_last(x)
        return (out, deep_out) if with_deep else out
