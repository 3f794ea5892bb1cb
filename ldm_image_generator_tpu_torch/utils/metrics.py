"""Structured train metrics, one JSON line per log step: the torch
counterpart of MetricLogger in ldm_image_generator_tpu/utils/metrics.py,
record for record (the same keys, rounding, steps_per_s and
images_per_s).

Metrics may be 0-d tensors on the card: `float(v)` waits for the
device, and happens only when a record is written.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional


def _record(step: int, t: float, metrics: Dict) -> dict:
    rec = {"step": step, "time": round(t, 2)}
    for k, v in metrics.items():
        try:
            rec[k] = round(float(v), 6)
        except (TypeError, ValueError):
            rec[k] = v
    return rec


class MetricLogger:
    def __init__(self, log_every: int = 10, stream=None):
        self.log_every = log_every
        self.stream = stream or sys.stdout
        self._t0 = time.perf_counter()
        self._last_t = self._t0
        self._last_step = 0

    def _write(self, rec: dict) -> None:
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()

    def log(self, step: int, metrics: Dict, batch_size: Optional[int] = None,
            **extra) -> None:
        """A record once at least log_every steps have passed since the
        last one (not step % N: a fused group advances step by N)."""
        if step - self._last_step < self.log_every:
            return
        now = time.perf_counter()
        dt = now - self._last_t
        dsteps = step - self._last_step
        rec = _record(step, now - self._t0, metrics)
        if dsteps > 0 and dt > 0:
            rec["steps_per_s"] = round(dsteps / dt, 3)
            if batch_size:
                rec["images_per_s"] = round(dsteps * batch_size / dt, 3)
        rec.update(extra)
        self._write(rec)
        self._last_t = now
        self._last_step = step

    def log_now(self, step: int, metrics: Dict, **extra) -> None:
        """One record now (validation results), leaving the throughput
        bookkeeping alone."""
        rec = _record(step, time.perf_counter() - self._t0, metrics)
        rec.update(extra)
        self._write(rec)
