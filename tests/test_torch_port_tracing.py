"""The port's own spans (utils/profiling.py span / record / tracing): the
recorder off and on, nesting per thread, the serving worker's spans
against ServerStats, the pipeline's steps and UNet calls, and the clock
they share with torch.profiler's events (on the host here, on the card in
the test marked cuda). Imports nothing of JAX, so the card runs it with
--noconftest."""
from __future__ import annotations

import itertools
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
from ldm_image_generator_tpu_torch.serving import SamplerServer
from ldm_image_generator_tpu_torch.utils import profiling


def by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_span_off_records_nothing_and_allocates_nothing():
    assert not profiling.recording()
    before = len(profiling.records())
    assert profiling.span("a") is profiling.span("b", i=1)
    with profiling.span("a", i=1) as s:
        assert s is None
    profiling.record("q", 1, 2, request=1)
    tracemalloc.start()
    try:
        for _ in itertools.repeat(None, 1000):
            with profiling.span("pipeline.step", i=3, t=999):
                pass
        grown, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert grown == 0
    assert len(profiling.records()) == before


def test_spans_nest_per_thread_and_record_spans_threads():
    def work(tag, out):
        with profiling.span("outer", tag=tag) as o:
            with profiling.span("inner", tag=tag) as i:
                time.sleep(0.005)
            out.append((o.id, i.id, threading.get_ident()))

    seen = []
    with profiling.tracing() as recs:
        threads = [threading.Thread(target=work, args=(k, seen)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        t0 = profiling.now_ns()
        profiling.record("serve.queue", t0 - 1000, t0, request=7)
    assert profiling.span("x") is profiling.span("y")  # off again
    assert len(recs) == 7 and len({r.id for r in recs}) == 7
    for outer_id, inner_id, tid in seen:
        (o,) = [r for r in recs if r.id == outer_id]
        (i,) = [r for r in recs if r.id == inner_id]
        assert (o.parent, i.parent) == (None, outer_id)
        assert o.thread == i.thread == tid
        assert o.attrs["tag"] == i.attrs["tag"]
        assert o.start_ns <= i.start_ns < i.end_ns <= o.end_ns
    (q,) = by_name(recs, "serve.queue")
    assert (q.parent, q.thread, q.end_ns - q.start_ns, q.attrs) == (None, None, 1000,
                                                                    {"request": 7})


def test_span_left_by_an_exception_is_closed_and_marked():
    with profiling.tracing() as recs:
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("x")
        with profiling.span("after"):
            pass
    inner, outer, after = recs
    assert inner.attrs == outer.attrs == {"error": "ValueError"}
    assert after.parent is None and after.attrs == {}


def stub_server(fail_first=False, max_wait_ms=30.0):
    calls = []

    def fn(seeds, batch):
        calls.append(batch)
        if fail_first and len(calls) == 1:
            raise RuntimeError("dispatch failed")
        time.sleep(0.002)
        return np.zeros((batch, 2, 2, 3), np.uint8)

    return SamplerServer(fn, batch_buckets=(1, 2, 4), max_wait_ms=max_wait_ms,
                         device="cpu")


@pytest.mark.parametrize("groups", [[1], [3], [3, 1], [4, 4, 2]])
def test_server_spans_link_each_request_to_its_dispatch(groups):
    server = stub_server()
    with profiling.tracing() as recs:
        with server:
            for n in groups:
                futures = [server.submit(k + 1) for k in range(n)]
                for f in futures:
                    f.result(timeout=10)
    stats = server.stats.snapshot()
    dispatches = {r.attrs["dispatch"]: r for r in by_name(recs, "serve.dispatch")}
    queue, service = by_name(recs, "serve.queue"), by_name(recs, "serve.service")
    assert len(queue) == len(service) == stats["requests"] == sum(groups)
    assert len({r.attrs["request"] for r in queue}) == sum(groups)
    assert ({r.attrs["request"]: r.attrs["dispatch"] for r in queue}
            == {r.attrs["request"]: r.attrs["dispatch"] for r in service})
    assert len(dispatches) == stats["batches"]
    assert sum(d.attrs["real"] for d in dispatches.values()) == stats["images"]
    assert (sum(d.attrs["bucket"] - d.attrs["real"] for d in dispatches.values())
            == stats["padded_images"])
    for d in dispatches.values():
        mine = [r for r in queue if r.attrs["dispatch"] == d.attrs["dispatch"]]
        assert len(mine) == d.attrs["real"] and d.attrs["bucket"] == server._bucket_for(
            d.attrs["real"])
        kids = {r.name for r in recs if r.parent == d.id}
        assert kids == {"serve.rows", "serve.to_host", "serve.resolve"}
        for q in mine:
            assert q.start_ns <= d.start_ns and q.end_ns <= d.start_ns
        for s in (r for r in service if r.attrs["dispatch"] == d.attrs["dispatch"]):
            assert d.start_ns - 10**6 <= s.start_ns <= d.start_ns and s.end_ns <= d.end_ns
    if groups == [1]:
        # a lone request waits max_wait for company before its dispatch
        assert (queue[0].end_ns - queue[0].start_ns) / 1e6 >= 30.0
    assert by_name(recs, "serve.take")


def test_no_span_stays_open_after_a_failed_dispatch():
    server = stub_server(fail_first=True, max_wait_ms=5.0)
    with profiling.tracing() as recs:
        with server:
            with pytest.raises(RuntimeError):
                server.submit(1).result(timeout=10)
            server.submit(2).result(timeout=10)
    first, second = sorted(by_name(recs, "serve.dispatch"), key=lambda r: r.attrs["dispatch"])
    assert first.attrs["error"] == "RuntimeError" and "error" not in second.attrs
    assert first.parent is second.parent is None
    assert all(r.parent is None for r in by_name(recs, "serve.take"))
    assert len(by_name(recs, "serve.queue")) == 2
    assert len(by_name(recs, "serve.service")) == 1


@pytest.fixture(scope="module")
def tiny_pipeline():
    torch.manual_seed(0)
    ucfg = UNetConfig(num_classes=3, fixed_expert_indices=(0, 1)).tiny()
    return LDMPipeline.random(ucfg, VAEConfig().tiny(), dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("sampler,guided", [("ddim", False), ("ddim", True),
                                            ("dpm++2m", True)])
def test_pipeline_records_a_step_per_timestep_and_each_unet_call(tiny_pipeline, sampler,
                                                                 guided):
    batch, steps = 2, 20
    extra = dict(condition=torch.tensor([0, 2]), guidance_scale=2.0) if guided else {}
    with profiling.tracing() as recs:
        tiny_pipeline.sample(torch.Generator().manual_seed(1), batch=batch, image_size=16,
                             num_steps=steps, sampler=sampler, **extra)
    (sample,) = by_name(recs, "pipeline.sample")
    assert sample.attrs == {"batch": batch, "steps": steps, "guided": guided}
    step_spans = by_name(recs, "pipeline.step")
    assert [r.attrs["i"] for r in step_spans] == list(range(steps))
    assert all(r.parent == sample.id for r in step_spans)
    unets = by_name(recs, "pipeline.unet")
    assert len(unets) == steps * (2 if guided else 1)
    assert sum(r.attrs["rows"] for r in unets) == (2 if guided else 1) * batch * steps
    branches = {r.attrs["branch"] for r in unets}
    assert branches == ({"cond", "uncond"} if guided else {"plain"})
    parents = {r.id for r in step_spans}
    assert all(r.parent in parents for r in unets)
    (decode,) = by_name(recs, "pipeline.decode")
    assert decode.parent == sample.id and decode.start_ns >= step_spans[-1].end_ns


def test_spans_follow_a_profiler_session_on_its_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    assert not profiling.recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("probe") as s:
            with record_function("probe_op"):
                time.sleep(0.01)
    assert not profiling.recording()
    (rec,) = [r for r in profiling.records() if r.id == s.id]
    (op,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe_op"]
    # the profiler's host op lies inside the span, both on one clock
    assert rec.start_ns <= op.start_ns() and op.start_ns() + op.duration_ns() <= rec.end_ns
    assert rec.end_ns - rec.start_ns < 10**9


@pytest.mark.cuda
def test_span_clock_is_the_device_traces():
    """A span around a spin kernel and a synchronize, in a device-only
    profile: the kernel's device interval lies inside the span, and the
    span ends within 100 us of the kernel's end. The session's first
    synchronize returns late (2.5 ms on an H100: the profiler's first
    activity flush, not the clock), so the first span is a warm-up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.tracing() as recs:
            for _ in range(21):
                with profiling.span("probe"):
                    torch.cuda._sleep(2_000_000)  # ~1 ms
                    torch.cuda.synchronize()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if "CUDA" in str(e.device_type()) and "spin_kernel" in e.name())
    spans = sorted((r.start_ns, r.end_ns) for r in recs)
    assert len(kernels) == len(spans) == 21
    leads = [k0 - s0 for (s0, _), (k0, _) in zip(spans, kernels)]
    lags = [s1 - k1 for (_, s1), (_, k1) in zip(spans, kernels)]
    print(f"span clock: kernel start - span start {leads[0]}, then {min(leads[1:])}.."
          f"{max(leads[1:])} ns; span end - kernel end {lags[0]}, then {min(lags[1:])}.."
          f"{max(lags[1:])} ns")
    assert min(leads) >= 0 and min(lags) >= 0
    assert max(lags[1:]) < 100_000
