"""The readers of the program's own spans (portbench/program_spans.py and
the metrics that read it) on synthetic device ops and program spans: idle
time named by span, summing to the window's idle time; a gap across two
spans split by overlap; UNet rows per image; the percentiles against
numpy's; and nothing read from a program that records no spans."""
from __future__ import annotations

import numpy as np
import pytest

from ldm_image_generator_tpu_torch.utils import profiling
from ldm_image_generator_tpu_torch.utils.profiling import Span
from portbench import harness, program_spans
from portbench.harness import Outcome
from portbench.trace import Trace

MAIN, WORKER = 11, 22


class Spans:
    """Program spans built in order, with ids and parents."""

    def __init__(self):
        self.list = []

    def add(self, name, start, end, parent=None, thread=MAIN, **attrs):
        s = Span(name, len(self.list) + 1, parent and parent.id, thread, start, end, attrs)
        self.list.append(s)
        return s


def outcome(trace, spans, monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: list(spans.list))
    program_spans._cache[:] = [None, None]
    return Outcome(metrics={}, attempted=1, failed=0, checks=[], memory_peak_bytes=0,
                   trace=trace)


def read(name, out):
    fn, rest = harness.reader(name)
    return fn(None, out, rest)


def cfg_window():
    """A window [0, 1000) with one benchmark span `sample` [100, 900): a
    guided call of 20 steps (two UNet calls each) on the main thread, the
    device busy but for gaps at [50, 120), [300, 340) and [950, 1000)."""
    trace = Trace(ops=[(0, 50, "k"), (120, 180, "k"), (340, 610, "k")], window=(0, 1000),
                  spans=[("sample", {"batch": 4}, 100, 900)])
    sp = Spans()
    call = sp.add("pipeline.sample", 105, 890, batch=4, steps=20, guided=True)
    for i in range(20):
        a = 110 + 35 * i
        step = sp.add("pipeline.step", a, a + 35, call, i=i, t=999 - 50 * i)
        sp.add("pipeline.unet", a + 2, a + 16, step, rows=4, branch="cond")
        sp.add("pipeline.unet", a + 17, a + 31, step, rows=4, branch="uncond")
    sp.add("pipeline.decode", 810, 880, call, rows=4)
    return trace, sp


def test_idle_by_span_sums_to_the_windows_idle_time(monkeypatch):
    trace, sp = cfg_window()
    win = program_spans.window(outcome(trace, sp, monkeypatch))
    idle = program_spans.named_idle(win)
    assert sum(idle.values()) == pytest.approx((trace.window_s - trace.busy_s()) * 1e9)
    assert sum(idle.values()) == 70 + 40 + 50
    # the benchmark's breakdown, each name split further by program span
    by_bench = {}
    for k, v in idle.items():
        by_bench[k.split("/")[0]] = by_bench.get(k.split("/")[0], 0) + v
    assert by_bench == {k: round(v * 1e9) for k, v in trace.breakdown()["idle_gaps"]}
    # [100, 120): the call alone from 105, step 0 from 110, its first UNet
    # call from 112; [300, 340) falls in step 5 [285, 320) and step 6
    # [320, 355), UNet calls at [287, 301), [302, 316), [322, 336), [337, 351)
    assert idle["sample/pipeline.unet"] == 8 + 1 + 14 + 14 + 3
    assert idle["sample/pipeline.step"] == 2 + 1 + 4 + 2 + 1
    assert idle["outside spans"] == 50 + 50  # [50, 100) and [950, 1000)
    assert idle["sample"] == 5 and idle["sample/pipeline.sample"] == 5


def test_a_gap_across_two_spans_is_split_by_overlap(monkeypatch):
    trace = Trace(ops=[(0, 100, "k"), (400, 600, "k")], window=(0, 1000),
                  spans=[("dispatch", {"bucket": 2}, 50, 1000)])
    sp = Spans()
    sp.add("serve.take", 0, 150, thread=WORKER)
    d = sp.add("serve.dispatch", 150, 990, thread=WORKER, dispatch=1, bucket=2, real=1)
    sp.add("serve.rows", 150, 180, d, thread=WORKER)
    sp.add("serve.noise", 180, 330, d, thread=WORKER, rows=2)
    sp.add("serve.queue", 0, 150, thread=None, request=1, dispatch=1)
    win = program_spans.window(outcome(trace, sp, monkeypatch))
    assert win.thread == WORKER
    idle = program_spans.named_idle(win)
    assert idle == {"dispatch/serve.take": 50, "dispatch/serve.rows": 30,
                    "dispatch/serve.noise": 150, "dispatch/serve.dispatch": 70 + 0}
    assert read("idle_in_pct.take.serve", win_out(trace)) == pytest.approx(100 * 50 / 1000)
    assert read("idle_in_pct.step.serve", win_out(trace)) is None


def win_out(trace):
    return Outcome(metrics={}, attempted=1, failed=0, checks=[], memory_peak_bytes=0,
                   trace=trace)


def test_unet_rows_per_image_of_a_guided_call_and_a_padded_dispatch(monkeypatch):
    trace, sp = cfg_window()
    out = outcome(trace, sp, monkeypatch)
    assert read("unet_rows_per_image.cfg", out) == 40.0
    assert read("idle_in_pct.step.cfg", out) == pytest.approx(
        100 * (40 + 10) / 1000)

    # served: bucket 4 with 3 real requests, 20 plain steps; a second
    # dispatch cut by the window's end is not counted
    trace = Trace(ops=[(0, 2000, "k")], window=(0, 1500), spans=[])
    sp = Spans()
    for n, (a, b) in enumerate([(10, 700), (800, 1600)], start=1):
        d = sp.add("serve.dispatch", a, b, thread=WORKER, dispatch=n, bucket=4, real=3)
        call = sp.add("pipeline.sample", a + 5, b - 5, d, thread=WORKER, batch=4, steps=20,
                      guided=False)
        for i in range(20):
            step = sp.add("pipeline.step", a + 10 + 30 * i, a + 39 + 30 * i, call,
                          thread=WORKER, i=i)
            sp.add("pipeline.unet", a + 11 + 30 * i, a + 38 + 30 * i, step, thread=WORKER,
                   rows=4, branch="plain")
    assert read("unet_rows_per_image.serve", outcome(trace, sp, monkeypatch)) == (
        20 * (3 + 1) / 3)


def test_queue_and_service_percentiles_agree_with_numpy(monkeypatch):
    rng = np.random.default_rng(5)
    trace = Trace(ops=[(0, 10**9, "k")], window=(10**6, 9 * 10**8), spans=[])
    sp = Spans()
    waits, services = [], []
    for k in range(200):
        start = int(rng.integers(0, 10**9 - 4 * 10**7))
        wait, service = (int(v) for v in rng.integers(10**5, 3 * 10**7, size=2))
        sp.add("serve.queue", start, start + wait, thread=None, request=k)
        sp.add("serve.service", start + wait, start + wait + service, thread=None, request=k)
        if trace.window[0] <= start + wait < trace.window[1]:
            waits.append(wait / 1e6)
            services.append(service / 1e6)
    out = outcome(trace, sp, monkeypatch)
    assert 0 < len(waits) < 200
    assert read("queue_wait_p95_ms.serve", out) == pytest.approx(np.percentile(waits, 95))
    assert read("service_p95_ms.serve", out) == pytest.approx(np.percentile(services, 95))


@pytest.mark.parametrize("name", ["queue_wait_p95_ms.serve", "service_p95_ms.serve",
                                  "idle_in_pct.step.cfg", "idle_in_pct.take.serve",
                                  "unet_rows_per_image.cfg"])
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    trace, _ = cfg_window()
    program_spans._cache[:] = [None, None]
    monkeypatch.delattr(profiling, "records")
    assert read(name, win_out(trace)) is None
    program_spans._cache[:] = [None, None]
    monkeypatch.setattr(profiling, "records", lambda: [], raising=False)
    assert read(name, win_out(trace)) is None
