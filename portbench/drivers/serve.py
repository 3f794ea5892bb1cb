"""Open-loop serving: requests arrive on the mix's schedule and go to the
port's SamplerServer (in process, no HTTP) over make_variants of the
configuration's pipeline. Each request is timed from when its arrival
was due to when its future resolved with an image. After the window, a
sample of the finished requests drawn from the seed is held against the
reference's images."""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time

import numpy as np
import torch

from portbench import compare, harness, program, schedule
from portbench import weights as W
from portbench.harness import Outcome, Run
from portbench.reference import sample as refs
from portbench.reference import unet as ref
from portbench.trace import Profile, Spans
from portbench.work import latent_side

# seconds a request may take past the window's close before it counts as
# failed
GRACE_S = 60.0


def variant_key(cfg: dict, kind: dict):
    """make_variants' key of a request kind: ("cfg", size) for a guided
    one, else the size."""
    size = kind.get("size", cfg["image_size"])
    return ("cfg", size) if kind.get("guidance") is not None else size


def run(r: Run) -> Outcome:
    dev, cfg, tr = r.device, r.cfg, r.traffic
    spans = Spans()
    pipe, unet = program.pipeline(cfg, r.seed, dev, int8=r.int8)
    harness.phase(r, "built")
    mix = tr.get("mix") or [{"share": 1.0}]
    variants = program.serve_variants(pipe, cfg["image_size"], cfg["num_steps"])
    dispatches = []  # (bucket, real images) per variant call
    took = []  # host seconds per variant call

    def wrap(fn):
        def call(seeds, batch, *a, **k):
            t = time.perf_counter()
            with spans.span("dispatch", bucket=batch):
                out = fn(seeds, batch, *a, **k)
            dispatches.append((batch, sum(1 for s in seeds if s != 0)))
            took.append(time.perf_counter() - t)
            return out
        return call

    served = {}
    for m in mix:
        key = variant_key(cfg, m)
        v = variants[key]
        served[key] = dataclasses.replace(v, fn=wrap(v.fn)) if hasattr(v, "fn") else wrap(v)
    unet_calls = [0]
    unet.register_forward_pre_hook(lambda *_: unet_calls.__setitem__(0, unet_calls[0] + 1))
    server = program.sampler_server(served, tr, dev)
    server.warmup()
    harness.phase(r, "warmed (dispatches of " + ", ".join(
        f"bucket {b}: {s:.2f} s" for (b, _), s in zip(dispatches, took)) + ")")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reqs = schedule.arrivals(tr, r.seed, r.seconds)
    dispatches.clear()
    took.clear()
    unet_calls[0] = 0
    before = server.stats.snapshot()
    overloaded = program.overloaded_error()
    done_at = [None] * len(reqs)
    futures = [None] * len(reqs)
    lateness = 0.0
    setup_s = time.time() - r.started
    server.start()
    prof = Profile(spans) if r.trace else None
    if prof:
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        for i, q in enumerate(reqs):
            due = t0 + q["due"]
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            lateness = max(lateness, time.perf_counter() - due)
            kind = mix[q["kind"]]
            try:
                f = server.submit(q["seed"], variant=variant_key(cfg, kind),
                                  guidance=kind.get("guidance"))
            except overloaded:
                continue
            futures[i] = f
            f.add_done_callback(lambda _f, i=i: done_at.__setitem__(i, time.perf_counter()))
        end = t0 + r.seconds
        if time.perf_counter() < end:
            time.sleep(end - time.perf_counter())
        if prof:
            prof.close()
        deadline = end + GRACE_S
        for f in futures:
            if f is not None:
                try:
                    f.exception(timeout=max(0.0, deadline - time.perf_counter()))
                except TimeoutError:
                    pass
    finally:
        if prof:
            prof.__exit__(None, None, None)
        server.stop()
    after = server.stats.snapshot()
    images = {}
    by_request = [None] * len(reqs)
    for i, f in enumerate(futures):
        if f is None or not f.done() or f.cancelled() or f.exception() is not None:
            continue
        images[i] = f.result()
        by_request[i] = (done_at[i] - (t0 + reqs[i]["due"])) * 1e3
    lat = [v for v in by_request if v is not None]
    failed = len(reqs) - len(images)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counters = {
        "server": {k: after[k] - before[k] for k in ("requests", "batches", "images",
                                                     "padded_images", "shed", "expired")},
        "dispatches": list(dispatches),
        "unet_calls": unet_calls[0],
        "late_s": lateness,
        "served": len(images),
        "latency_ms": by_request,
    }
    trace = prof.reduce() if prof else None
    metrics = {"setup_s": setup_s}
    if lat:
        # linear interpolation between ranks
        metrics["serve_p95_ms"] = float(np.percentile(np.asarray(lat, dtype=np.float64), 95))
    per_bucket = {}
    for (b, _), s in zip(dispatches, took):
        per_bucket.setdefault(b, []).append(s)
    print(f"serve: {len(reqs)} requests, {len(images)} served, p50 "
          f"{statistics.median(lat) if lat else float('nan'):.1f} ms, generator late by up to "
          f"{lateness * 1e3:.1f} ms, {len(dispatches)} dispatches (median host s by bucket: "
          + ", ".join(f"{b}: {statistics.median(v):.3f} x{len(v)}"
                      for b, v in sorted(per_bucket.items())) + ")", file=sys.stderr, flush=True)
    del server, served, variants, pipe, unet
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(r, reqs, images)
    counters["numbers"] = numbers
    checks = compare.limited(numbers, r.limits)
    return Outcome(metrics=metrics, attempted=len(reqs), failed=failed, checks=checks,
                   memory_peak_bytes=peak, counters=counters, trace=trace)


def pick(r: Run, done) -> list:
    """`check_requests` of the finished request indices, drawn from the seed."""
    g = schedule.rng(r.seed, 2)
    k = min(r.traffic["check_requests"], len(done))
    return sorted(int(i) for i in g.choice(sorted(done), size=k, replace=False))


def reference_images(r: Run, reqs, idx, rounding=None) -> np.ndarray:
    """The reference's uint8 images of requests idx (their seeds, kinds
    and the serving CLI's routing seed 0), in idx's order."""
    cfg, dev = r.cfg, r.device
    dt = getattr(torch, cfg["compute_dtype"])
    P = {n: t.float() for n, t in W.make(ref.unet_shapes(cfg["unet"]), r.seed, "unet",
                                         dev, dt).items()}
    D = {n: t.float() for n, t in W.make(ref.decoder_shapes(cfg["vae"]), r.seed, "decoder",
                                         dev, dt).items()}
    lat = latent_side(cfg)
    shape = (lat, lat, cfg["unet"]["input_channels"])
    mix = r.traffic.get("mix") or [{"share": 1.0}]
    out = {}
    groups = {}
    for i in idx:
        groups.setdefault(mix[reqs[i]["kind"]].get("guidance"), []).append(i)
    for guidance, group in groups.items():
        noise = torch.stack([refs.request_noise(reqs[i]["seed"], shape) for i in group]).to(dev)
        classes = None
        if guidance is not None:
            # a guided request without a class rides the null class
            classes = torch.full((len(group),), cfg["unet"]["num_classes"], dtype=torch.int64)
        imgs, _ = refs.images(P, D, cfg, noise, 0, classes, guidance or 1.0,
                              rounding=rounding)
        out.update(zip(group, imgs.numpy()))
    return np.stack([out[i] for i in idx])


def check(r: Run, reqs, images: dict) -> dict:
    """compare.image_numbers of `check_requests` finished requests drawn
    from the seed, against the reference's images of the same requests."""
    if not images or not r.traffic["check_requests"]:
        return {}
    ref.precise()
    idx = pick(r, images)
    want = reference_images(r, reqs, idx)
    return compare.image_numbers([refs.gaps(np.stack([images[i] for i in idx]), want)])


def control(r: Run) -> dict:
    """The numbers of the control: the reference with its products in fp8
    in the program's place, on the requests a run of this seed offers."""
    ref.precise()
    reqs = schedule.arrivals(r.traffic, r.seed, r.seconds)
    idx = pick(r, range(len(reqs)))
    got = reference_images(r, reqs, idx, rounding=ref.control_rounding(r.cfg))
    return compare.image_numbers([refs.gaps(got, reference_images(r, reqs, idx))])
