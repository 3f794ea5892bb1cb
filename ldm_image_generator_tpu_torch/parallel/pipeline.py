"""GPipe pipeline parallelism: the torch counterpart of
ldm_image_generator_tpu/parallel/pipeline.py.

Consecutive shape-preserving stages run on consecutive devices and
microbatches stream through them: on tick k of the T = M + S - 1 ticks,
stage i computes microbatch k - i (where 0 <= k - i < M) on what stage
i - 1 handed it on tick k - 1, so stage i works on microbatch j while
stage i + 1 works on microbatch j - 1. The JAX package runs the ticks as
a lax.scan inside shard_map with a ppermute between stages; here the
ticks are a host loop that launches each stage's work on its own device
(CUDA launches are asynchronous, so stages on different cards overlap)
and moves each output to the next stage's device.

The backward is autograd through the schedule: every microbatch's chain
of stages is recorded, so the backward runs the reverse schedule, as the
transpose of JAX's scan does; there is no hand-written backward.
`devices` may name one device several times: one card (or the CPU) then
hosts every stage, as JAX's virtual CPU devices do.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch


def _map(fn, tree):
    """fn over every tensor of a tensor, tuple, list or dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    raise TypeError(f"a pipeline stream cannot hold a {type(tree).__name__}")


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def _zip_map(fn, trees: list):
    """fn over the tensors at one place in each of `trees` (one structure)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn([t for t in trees])
    if isinstance(first, (tuple, list)):
        return type(first)(_zip_map(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}


def on_device(device: torch.device):
    """Make `device` current while a stage launches (the kernels take
    tensors on the current CUDA device)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def pipeline_apply(block_fn: Callable[[Any, Any], Any], stage_params: Sequence,
                   x: Any, devices: Sequence, num_microbatches: Optional[int] = None):
    """x through S = len(stage_params) pipelined stages; equals
    sequential_apply(block_fn, stage_params, x).

    block_fn(params_i, x_mb) -> y_mb keeps the stream's structure and
    leaf shapes; stage i's params live on devices[i]. x is a [B, ...]
    tensor or a tuple, list or dict of them sharing B (pass-through
    leaves let per-sample conditioning ride with the activations); B
    must divide into num_microbatches (default S). The output is on x's
    device."""
    s = len(stage_params)
    if len(devices) != s:
        raise ValueError(f"{len(devices)} devices for {s} stages")
    m = num_microbatches or s
    leaves = _leaves(x)
    b = leaves[0].shape[0]
    if any(lf.shape[0] != b for lf in leaves):
        raise ValueError("stream leaves must share the batch dimension")
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    home = leaves[0].device
    devices = [torch.device(d) for d in devices]
    chunks = [_map(lambda a, j=j: a[j * (b // m):(j + 1) * (b // m)], x)
              for j in range(m)]
    held = [None] * s      # stage i's output of the previous tick
    outputs = [None] * m
    for tick in range(m + s - 1):
        new = [None] * s
        for i in range(s):
            j = tick - i
            if not 0 <= j < m:
                continue
            inp = chunks[j] if i == 0 else held[i - 1]
            with on_device(devices[i]):
                inp = _map(lambda a, d=devices[i]: a.to(d, non_blocking=True), inp)
                new[i] = block_fn(stage_params[i], inp)
            if i == s - 1:
                outputs[j] = new[i]
        held = new
    return _zip_map(lambda parts: torch.cat([p.to(home) for p in parts]), outputs)


def sequential_apply(block_fn: Callable[[Any, Any], Any], stage_params: Sequence, x):
    """Reference semantics of pipeline_apply: the stages in turn on the
    whole batch."""
    for params in stage_params:
        x = block_fn(params, x)
    return x
