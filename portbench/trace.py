"""The traced run's spans and their reduction.

A span is a stretch of the benchmark's own code (a served dispatch, a
sample call, a train step). Its bounds are placed into the card's own
timeline by marker kernels (torch.cuda._sleep, which the program never
launches) enqueued on the same stream as the work: the k-th marker on
the device is the k-th the harness launched, so kernels between a span's
two markers ran for that span, with no clock shared between host and
device. The profiler records device activity only (no host ops), and its
events are reduced in memory: nothing is written to disk.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
from typing import List, Optional

import torch

MARKER = "spin_kernel"
WINDOW = "window"


class Spans:
    """Span bounds in launch order; inert (no marker, no cost) outside a
    traced window."""

    def __init__(self):
        self.enabled = False
        self.marks: List[tuple] = []  # (kind 'begin'|'end', name, meta)
        self._lock = threading.Lock()

    def mark(self, kind: str, name: str, meta: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            if self.enabled:
                self.marks.append((kind, name, meta or {}))
                torch.cuda._sleep(1)

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        self.mark("begin", name, meta)
        try:
            yield
        finally:
            self.mark("end", name, meta)


class Profile:
    """torch.profiler over the device only, started and stopped around
    the window (`with Profile(spans) as p:`); p.reduce() afterwards."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.spans.enabled = True
        self.spans.mark("begin", WINDOW)
        return self

    def close(self) -> None:
        """End the window (idempotent): spans still open end with it."""
        with self.spans._lock:
            if self.spans.enabled:
                self.spans.marks.append(("end", WINDOW, {}))
                torch.cuda._sleep(1)
                self.spans.enabled = False

    def __exit__(self, *exc):
        self.close()
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> "Trace":
        evs = []
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            evs.append((e.start_ns(), e.duration_ns(), e.name()))
        self._prof = None
        return Trace.from_events(evs, self.spans.marks)


class Trace:
    """Device ops of the window [(start_ns, dur_ns, name)] in device order
    (markers removed), the window's bounds and the spans [(name, meta,
    start_ns, end_ns)] on the device clock; a span the window's end cut
    has meta["cut"]."""

    def __init__(self, ops, window, spans):
        self.ops = ops
        self.window = window
        self.spans = spans
        self._starts = None

    @classmethod
    def from_events(cls, events, marks) -> "Trace":
        events = sorted(events)
        markers = [e for e in events if MARKER in e[2]]
        if len(markers) != len(marks):
            raise RuntimeError(f"trace: {len(markers)} marker kernels on the device, "
                               f"{len(marks)} launched")
        open_, spans, window = {}, [], None
        for (kind, name, meta), (start, dur, _) in zip(marks, markers):
            key = (name, tuple(sorted(meta.items())))
            if kind == "begin":
                open_.setdefault(key, []).append(start + dur)
                continue
            if not open_.get(key):
                continue  # its begin came before the window
            begin = open_[key].pop(0)
            if name == WINDOW:
                window = (begin, start)
            else:
                spans.append((name, meta, begin, start))
        lo, hi = window
        # spans still open when the window closed end with it
        spans += [(key[0], dict(key[1], cut=True), b, hi) for key, begins in open_.items()
                  for b in begins if key[0] != WINDOW]
        ops = [e for e in events if MARKER not in e[2] and lo <= e[0] < hi]
        spans.sort(key=lambda s: s[2])
        return cls(ops, window, spans)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the ops' intervals, clipped to the window)."""
        total, cur_lo, cur_hi = 0, None, None
        lo_w, hi_w = self.window
        for start, dur, _ in self.ops:
            a, b = max(start, lo_w), min(start + dur, hi_w)
            if b <= a:
                continue
            if cur_hi is None or a > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = a, b
            else:
                cur_hi = max(cur_hi, b)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total / 1e9

    def gaps(self):
        """[(start_ns, end_ns)] of the window's idle stretches."""
        out, t = [], self.window[0]
        for start, dur, _ in self.ops:
            if start > t:
                out.append((t, start))
            t = max(t, start + dur)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def done_share(self, name: str, meta: dict, a: int, b: int) -> float:
        """The share of a span's work done in the window: 1, or for a cut
        span its time in the window over the median length of the whole
        spans of its name and meta."""
        if not meta.get("cut"):
            return 1.0
        whole = sorted(e - s for n, m, s, e in self.spans if n == name and not m.get("cut")
                       and all(m.get(k) == v for k, v in meta.items() if k != "cut"))
        return min(1.0, (b - a) / whole[len(whole) // 2]) if whole else 0.0

    def ops_in(self, a: int, b: int) -> list:
        """The ops that started in [a, b)."""
        if self._starts is None:
            self._starts = [e[0] for e in self.ops]
        return self.ops[bisect.bisect_left(self._starts, a):bisect.bisect_left(self._starts, b)]

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, by name, and the idle time
        by the span it fell in, each list of `top` [name, seconds]."""
        by_op = {}
        for _, dur, name in self.ops:
            by_op[name] = by_op.get(name, 0) + dur
        idle, i = {}, 0
        for a, b in self.gaps():  # both in time order; spans do not overlap
            while i < len(self.spans) and self.spans[i][3] <= a:
                i += 1
            j = i
            while a < b:
                if j < len(self.spans) and self.spans[j][2] <= a:
                    name, end = self.spans[j][0], min(b, self.spans[j][3])
                    j += 1
                else:
                    nxt = self.spans[j][2] if j < len(self.spans) else b
                    name, end = "outside spans", min(b, nxt)
                idle[name] = idle.get(name, 0) + (end - a)
                a = end
        rank = lambda d: [[k[:200], v / 1e9] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}
