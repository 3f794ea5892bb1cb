"""The program's own spans in a traced window, for the per-layer readers.

The port records spans while a torch.profiler session is on
(ldm_image_generator_tpu_torch/utils/profiling.py: a served request's
queue wait and service, the worker's take and dispatch, the pipeline's
sample calls, sampler steps and UNet calls), stamped on the clock of the
profiler's events: the same timeline as the trace's device ops and its
window. So trace.Profile, which profiles the window, switches them on with
it; this module reads them back, clipped to the window, and puts each idle
stretch of the device down to where the launching thread's host was.

Besides portbench/program.py, the one module of the harness that imports
the port. A program that records no spans (one without
profiling.records) gives None here, and every reader then returns None.
"""
from __future__ import annotations

import sys
from collections import Counter
from typing import Dict, List, Optional

OUTSIDE = "outside spans"  # trace.Trace.breakdown's name for idle outside its spans

_cache: list = [None, None]  # [trace, Window] of the last window read


class Window:
    """The program's spans of one traced window: `spans` those that ended
    at or after its start, `thread` the thread that launched the device
    work (the one that recorded most spans), `lo`, `hi` the window's
    bounds (ns)."""

    def __init__(self, trace, spans):
        self.trace = trace
        self.lo, self.hi = trace.window
        self.spans = [s for s in spans if s.end_ns >= self.lo and s.start_ns < self.hi]
        threads = Counter(s.thread for s in self.spans if s.thread is not None)
        self.thread = threads.most_common(1)[0][0] if threads else None
        self.by_id = {s.id: s for s in spans}

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def whole(self, name: str) -> list:
        """Spans `name` that lie wholly in the window."""
        return [s for s in self.named(name) if s.start_ns >= self.lo and s.end_ns <= self.hi]

    def on_thread(self) -> list:
        return [s for s in self.spans if s.thread == self.thread]

    def ancestor(self, span, names) -> Optional[object]:
        """The nearest enclosing span of `span` with a name in `names`."""
        p = self.by_id.get(span.parent)
        while p is not None and p.name not in names:
            p = self.by_id.get(p.parent)
        return p


def window(out) -> Optional[Window]:
    """The program's spans of out's traced window, or None (no trace, or a
    program that records none)."""
    tr = out.trace
    if tr is None or tr.window is None:
        return None
    if _cache[0] is tr:
        return _cache[1]
    got = None
    try:
        from ldm_image_generator_tpu_torch.utils import profiling
    except ImportError:
        profiling = None
    read = getattr(profiling, "records", None)
    if read is not None:
        spans = read()
        if any(s.end_ns >= tr.window[0] and s.start_ns < tr.window[1] for s in spans):
            got = Window(tr, spans)
            report(got)
    _cache[0], _cache[1] = tr, got
    return got


def innermost(spans) -> List[tuple]:
    """[(start, end, name)] in time order: the stretches in which a span of
    `spans` (one thread's, so nested) was open, each named by the innermost
    one."""
    segs, stack, cur = [], [], None

    def close(until):
        nonlocal cur
        while stack and stack[-1].end_ns <= until:
            top = stack.pop()
            if cur is None or top.end_ns > cur:
                segs.append((top.start_ns if cur is None else max(cur, top.start_ns),
                             top.end_ns, top.name))
                cur = top.end_ns

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        close(s.start_ns)
        if stack and (cur is None or s.start_ns > cur):
            a = stack[-1].start_ns if cur is None else max(cur, stack[-1].start_ns)
            if s.start_ns > a:
                segs.append((a, s.start_ns, stack[-1].name))
        cur = s.start_ns if cur is None else max(cur, s.start_ns)
        stack.append(s)
    close(float("inf"))
    return segs


def bench_idle(trace) -> List[tuple]:
    """[(benchmark span name, start, end)] of the window's idle stretches,
    as trace.Trace.breakdown names them (the benchmark span they fell in,
    else OUTSIDE)."""
    out, i = [], 0
    spans = trace.spans
    for a, b in trace.gaps():
        while i < len(spans) and spans[i][3] <= a:
            i += 1
        j = i
        while a < b:
            if j < len(spans) and spans[j][2] <= a:
                name, end = spans[j][0], min(b, spans[j][3])
                j += 1
            else:
                nxt = spans[j][2] if j < len(spans) else b
                name, end = OUTSIDE, min(b, nxt)
            if end > a:
                out.append((name, a, end))
            a = end
    return out


def overlay(pieces, segs) -> Dict[str, int]:
    """{name: ns}: each piece (name, a, b) split by the segments (a', b',
    inner) it overlaps, named "name/inner", the rest "name". Both lists in
    time order and each without overlaps."""
    got: Dict[str, int] = {}
    j = 0
    for name, a, b in pieces:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while a < b:
            if k < len(segs) and segs[k][0] < b:
                s0, s1, inner = segs[k]
                if s0 > a:
                    got[name] = got.get(name, 0) + (s0 - a)
                    a = s0
                end = min(b, s1)
                if end > a:
                    key = f"{name}/{inner}"
                    got[key] = got.get(key, 0) + (end - a)
                    a = end
                k += 1
            else:
                got[name] = got.get(name, 0) + (b - a)
                a = b
    return got


def named_idle(win: Window) -> Dict[str, int]:
    """{name: idle ns}: trace.Trace.breakdown's idle_gaps split by the
    innermost program span open on the launching thread ("dispatch/
    pipeline.unet", "outside spans/serve.take"); the sum is the window's
    idle time."""
    return overlay(bench_idle(win.trace), innermost(win.on_thread()))


def idle_inside(win: Window, name: str) -> int:
    """Idle ns of the device while the launching thread was inside a span
    `name` (at any depth below it)."""
    # spans of one name on one thread follow each other without overlap
    segs = sorted((max(s.start_ns, win.lo), min(s.end_ns, win.hi), name)
                  for s in win.on_thread() if s.name == name)
    pieces = [("idle", a, b) for a, b in win.trace.gaps()]
    return overlay(pieces, segs).get(f"idle/{name}", 0)


def report(win: Window) -> None:
    """One line on standard error: the number of program spans in the
    window (and of those the program did not keep), the idle time by
    benchmark and program span, and how much of the idle time inside the
    benchmark's spans a program span names."""
    idle = named_idle(win)
    inside = {k: v for k, v in idle.items() if not k.startswith(OUTSIDE)}
    named = sum(v for k, v in inside.items() if "/" in k)
    total = sum(inside.values())
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:12]
    from ldm_image_generator_tpu_torch.utils import profiling

    print(f"program spans: {len(win.spans)} in the window ({profiling.dropped()} dropped); "
          "idle by span "
          + ", ".join(f"{k} {v / 1e9:.4f} s" for k, v in top)
          + f"; named inside the benchmark's spans {named / 1e9:.4f} of {total / 1e9:.4f} s",
          file=sys.stderr, flush=True)
