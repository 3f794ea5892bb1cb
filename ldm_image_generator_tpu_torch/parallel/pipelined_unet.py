"""Pipeline-parallel UNet forward: the deep SwinStacks run through the
GPipe schedule (parallel/pipeline.py). The torch counterpart of
ldm_image_generator_tpu/parallel/pipelined_unet.py, for `train_ldm
--pipeline-stages S`.

Which blocks pipeline (the JAX package's rule): every SwinBlock without
attention has the same parameter structure and the same maths (the
shift only reaches the attention branch), so a stack's homogeneous
prefix, all blocks of an encoder stack and all but the two attention
blocks of a decoder stack, pipelines when it divides into S stages
(each stage a run of prefix / S consecutive blocks); otherwise it runs
in turn on the whole batch. The attention tails always run in turn.

The forward walks the UNet's own modules (models/unet.py UNet.forward),
so there is one parameter set: the blocks of pipeline stage i are moved
to devices[i], everything else stays on devices[0]. The stream is
(x, t[, cond]): FiLM is computed per sample from t inside each block, so
each microbatch carries its own timesteps (and, in a decoder stack of a
conditioned forward, its own condition tokens). The routing plan and the
stochastic-depth gates are drawn once per forward, as the plain forward
draws them, and each block's row applies to every microbatch. With
cfg.remat each stage's blocks run under torch.utils.checkpoint.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ldm_image_generator_tpu_torch.models.unet import UNet, avg_pool_2x, upsample_nearest_2x
from ldm_image_generator_tpu_torch.parallel.pipeline import pipeline_apply


def pipelined_blocks(num_blocks: int, attention: bool, stages: int) -> int:
    """How many leading blocks of a stack pipeline over `stages` stages:
    its homogeneous prefix when that divides into them, else 0."""
    prefix = max(num_blocks - 2 if attention else num_blocks, 0)
    return prefix if stages > 1 and prefix >= stages and prefix % stages == 0 else 0


class PipelinedUNet:
    """apply_fn of the LDM train step: unet's forward with its deep
    stacks pipelined over `devices` (one per stage; a device may repeat)
    in num_microbatches microbatches (default: one per stage)."""

    def __init__(self, unet: UNet, devices: Sequence, num_microbatches: Optional[int] = None):
        self.unet = unet
        self.devices = [torch.device(d) for d in devices]
        self.num_microbatches = num_microbatches or len(self.devices)
        s = len(self.devices)
        cfg = unet.cfg
        # {stack name: [[block, ...] per stage]}
        self.stage_blocks = {}
        for name in unet.stage_names():
            stack = getattr(unet, name)
            n = pipelined_blocks(stack.num_blocks, name.startswith("dec"), s)
            if n:
                per = n // s
                blocks = stack.blocks()
                self.stage_blocks[name] = [blocks[i * per:(i + 1) * per] for i in range(s)]
                for i, run in enumerate(self.stage_blocks[name]):
                    for block in run:
                        block.to(self.devices[i])
        self.remat = cfg.remat

    def pipelined(self) -> dict:
        """{stack name: blocks per stage} of the stacks that pipeline."""
        return {k: len(v[0]) for k, v in self.stage_blocks.items()}

    def _run_stack(self, name: str, x, t, expert_ids, gates, cond):
        stack = getattr(self.unet, name)
        blocks = stack.blocks()
        row = lambda rows, k: None if rows is None else rows[k]
        runs = self.stage_blocks.get(name)
        first = 0
        if runs is not None:
            per = len(runs[0])
            stage_params = [
                [(blk, row(expert_ids, i * per + k), row(gates, i * per + k))
                 for k, blk in enumerate(run)]
                for i, run in enumerate(runs)]

            def block_fn(params, stream):
                def body(xx, tt, cc):
                    dev = xx.device
                    for blk, ids, gate in params:
                        xx = blk(xx, tt, expert_ids=None if ids is None else ids.to(dev),
                                 gate=None if gate is None else gate.to(dev), cond=cc)
                    return xx
                xx, tt = stream[0], stream[1]
                cc = stream[2] if len(stream) > 2 else None
                if self.remat and torch.is_grad_enabled():
                    xx = checkpoint(body, xx, tt, cc, use_reentrant=False)
                else:
                    xx = body(xx, tt, cc)
                return (xx,) + tuple(stream[1:])

            stream = (x, t) if cond is None else (x, t, cond)
            x = pipeline_apply(block_fn, stage_params, stream, self.devices,
                               self.num_microbatches)[0]
            first = len(runs) * per
        for k in range(first, len(blocks)):
            x = blocks[k](x, t, expert_ids=row(expert_ids, k), gate=row(gates, k),
                          cond=cond)
        return x

    def __call__(self, x, t, condition=None, moe_plan=None, generator=None,
                 sd_gates=None, deterministic: bool = True, dtype=None):
        """UNet.forward's output for these arguments (no FiLM replay or
        DeepCache), with the pipelined stacks run through the schedule."""
        unet = self.unet
        n = len(unet.cfg.channels)
        dt = dtype or unet.dtype
        routes = unet.routing(moe_plan, generator)
        gates = None if deterministic else unet.sd_gates(sd_gates, generator)
        cond = unet.condition_tokens(condition, dt)
        t = t.reshape(-1)
        if t.shape[0] == 1:
            t = t.expand(x.shape[0])

        def run(name, x):
            return self._run_stack(name, x, t,
                                   None if routes is None else routes[name],
                                   None if gates is None else gates[name],
                                   cond if name.startswith("dec") else None)

        x = unet.encoder_first(x.to(dt))
        skips = []
        for i in range(n):
            x = run(f"enc_stage_{i}", x)
            if i == n - 1:
                skips.append(None)  # zero bottleneck skip
            else:
                skips.append(x)
                x = avg_pool_2x(getattr(unet, f"enc_chconv_{i}")(x))
        for i in reversed(range(n)):
            if i != n - 1:
                x = getattr(unet, f"dec_chconv_{i}")(upsample_nearest_2x(x))
            if skips[i] is not None:
                x = x + skips[i]
            x = run(f"dec_stage_{i}", x)
        return unet.decoder_last(x)
