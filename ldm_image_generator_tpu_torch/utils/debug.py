"""Numerical guards and the SIGTERM hook of the trainers, the torch
counterparts of ldm_image_generator_tpu/utils/debug.py.

finite_flag stays on the device (no host sync); the trainers read their
metrics with assert_finite_metrics at a cadence, not every step. A
SIGTERM sets GracefulShutdown's flag, and the train loop saves and exits
at the end of the step it is in.
"""
from __future__ import annotations

import signal
from typing import Any, Iterable

import torch
from torch import nn


def _float_leaves(tree: Any):
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)


def finite_flag(tree: Any) -> torch.Tensor:
    """0-d bool tensor: True iff every floating tensor of `tree` (a
    tensor, a dict or list of them, or a module's parameters) is finite.
    Computed on the tensors' device, without waiting for it."""
    flags = [torch.isfinite(t).all() for t in _float_leaves(tree)]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


class NonFiniteError(RuntimeError):
    pass


def assert_finite_metrics(metrics: dict, step: int) -> None:
    """Host-side check at log cadence; raises with context on NaN/Inf."""
    for k, v in metrics.items():
        try:
            f = float(v)
        except (TypeError, ValueError, RuntimeError):
            continue
        if f != f or f in (float("inf"), float("-inf")):
            raise NonFiniteError(f"non-finite metric {k}={f} at step {step}")


class GracefulShutdown:
    """SIGTERM (or the given signals) -> set `requested`; the train loop
    checks it after every step and saves before exiting. restore() puts
    the previous handlers back. Installs nothing off the main thread,
    where signal.signal raises."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}
