"""The port's serving layer (serving.py, cli/serve.py) against the JAX
package's: the same dispatch sequence and counters for the same request
scripts, the same Prometheus text, the counterparts of
tests/test_serving.py, and served images within 1 of the JAX pipeline's
for the same x_T (tiny config, CPU, fp32, routing pinned).

Every request script here is submitted before the worker starts, so the
groups the worker cuts do not depend on timing; every wait has a timeout
and every server is stopped in a finally."""
import base64
import contextlib
import inspect
import http.client
import io
import json
import threading
import time
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from ldm_image_generator_tpu import serving as jserving
from ldm_image_generator_tpu.cli import serve as jserve
from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.pipelines import LDMPipeline as JPipeline
from ldm_image_generator_tpu_torch import serving
from ldm_image_generator_tpu_torch.cli import serve
from ldm_image_generator_tpu_torch.cli.sample_ldm import png_bytes
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import decoder_from_flax, unet_from_flax
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
from ldm_image_generator_tpu_torch.serving import (
    SamplerServer,
    ServerOverloaded,
    Variant,
)

torch.set_num_threads(1)
WAIT = 60  # seconds any single wait may take


def tiny_sample(seeds, batch):
    """A stand-in with the variant contract: fn(seeds, batch) -> uint8
    [batch, 8, 8, 3], deterministic per seed."""
    return np.stack([np.random.default_rng(s).integers(0, 255, (8, 8, 3), np.uint8)
                     for s in seeds])


def row_image(row, batch, scale=1.0):
    """uint8 [batch, 8, 8, 3] whose pixels are each row value * scale
    (a torch tensor, as the pipeline variants return)."""
    return (row.float() * scale)[:, None, None, None].expand(batch, 8, 8, 3).to(torch.uint8)


def encode_jpeg(img) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(np.asarray(img)).save(buf, format="JPEG")
    return buf.getvalue()


@contextlib.contextmanager
def running(srv):
    """srv started; stopped (and its worker joined) on the way out."""
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()
        assert srv._worker is None


@contextlib.contextmanager
def http_server(srv, encode=encode_jpeg, start=True, **kw):
    """(port) of a ThreadingHTTPServer on loopback over srv's handler,
    with srv's worker started unless start=False; both stopped after."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(srv, encode, **kw))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    if start:
        srv.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=WAIT)
        srv.stop()
        assert not t.is_alive()


def fetch(port, path, method="GET", body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request(method, path, body, headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def image_mean(body) -> float:
    return float(np.asarray(PIL.Image.open(io.BytesIO(body))).mean())


def multipart_parts(raw: bytes) -> list:
    """[(headers dict, body bytes)] of a multipart/mixed ldmframe stream."""
    parts = []
    for p in raw.split(b"--ldmframe"):
        if not p.strip() or p.strip() == b"--":
            continue
        head, body = p.split(b"\r\n\r\n", 1)
        fields = dict(line.split(b": ", 1) for line in head.strip().split(b"\r\n"))
        parts.append(({k.decode(): v.decode() for k, v in fields.items()},
                      body[:-2] if body.endswith(b"\r\n") else body))
    return parts


# -- the port's server against the JAX server on the same scripts ------------

def recorder(log, name, port: bool):
    """A variant fn recording (name, batch, seeds, rows, payload ids) and
    returning zeros; `port` picks the port's (seeds) or JAX's (keys)
    contract."""
    def fn(first, batch, *rows, payload=None):
        seeds = list(first) if port else np.asarray(first)[:, 1].tolist()
        log.append((name, batch, seeds, [np.asarray(r).tolist() for r in rows],
                    None if payload is None else np.asarray(payload)[:, 0, 0, 0].tolist()))
        return np.zeros((batch, 2, 2, 3), np.uint8)
    return fn


def build(mod, spec, log, **kw):
    """A server of module `mod` (the port's or JAX's serving) over the
    variants spec {key: Variant keyword dict} with recording fns."""
    port = mod is serving
    variants = {k: mod.Variant(recorder(log, str(k), port), **v) for k, v in spec.items()}
    if port:
        kw["device"] = "cpu"
    return mod.SamplerServer(variants, **kw)


ROWS = dict(takes_guidance=True, takes_negative=True, takes_rescale=True)
SCRIPTS = {
    # an oversize group split, priorities within a group, a cancelled and
    # an expired request, two variants by oldest request
    "split_priority_ttl_cancel": dict(
        spec={"a": {}, "b": {}}, kw=dict(batch_buckets=(1, 2, 4)),
        subs=[("a", 1, dict(priority=2)), ("a", 2, {}), ("b", 3, {}),
              ("a", 4, dict(priority=0)), ("a", 5, dict(ttl_s=1e-3)),
              ("a", 6, {}), ("b", 7, dict(priority=0)), ("a", 8, dict(cancel=True)),
              ("a", 9, dict(priority=1)), ("a", 10, {})]),
    # class ids and the guidance, negative and rescale rows with padding
    "conditional_rows": dict(
        spec={8: {}, ("cfg", 8): ROWS}, kw=dict(batch_buckets=(1, 2, 4), num_classes=3),
        subs=[(8, 1, dict(class_id=2)), (("cfg", 8), 2, dict(class_id=0, guidance=3.0)),
              (8, 3, {}), (("cfg", 8), 4, dict(class_id=1, guidance=5.0, cfg_rescale=0.7)),
              (("cfg", 8), 5, dict(guidance=2.0, negative_class=1)),
              (8, 6, dict(class_id=1, priority=0))]),
    # payload variants (an img2img payload and its guided twin)
    "payloads": dict(
        spec={"i2i": dict(payload_shape=(2, 2, 4)),
              "cfg_i2i": dict(payload_shape=(2, 2, 4), **ROWS), "gen": {}},
        kw=dict(batch_buckets=(2, 4), num_classes=4),
        subs=[("i2i", 1, dict(payload=1.0)), ("gen", 2, {}),
              ("cfg_i2i", 3, dict(payload=2.0, guidance=4.0, class_id=3)),
              ("i2i", 4, dict(payload=3.0, class_id=0)),
              ("cfg_i2i", 5, dict(payload=4.0, guidance=1.5, cfg_rescale=0.25))]),
    # admission shares: background shed first, the hard bound for all
    "admission": dict(
        spec={"a": {}}, kw=dict(batch_buckets=(1, 8), max_queue=6,
                                admit_fractions=(1.0, 0.8, 0.5)),
        subs=[("a", i, dict(priority=p)) for i, p in
              enumerate([2, 2, 2, 2, 1, 1, 1, 0, 0, 0, 0])]),
}


def run_script(mod, name):
    """(dispatch log, counters, latency count, outcomes) of SCRIPTS[name]
    on a server of `mod`, all submitted before the worker starts."""
    script = SCRIPTS[name]
    log = []
    srv = build(mod, script["spec"], log, max_wait_ms=1, **script["kw"])
    futs, outcomes = [], []
    for variant, seed, opts in script["subs"]:
        opts = dict(opts)
        cancel = opts.pop("cancel", False)
        if "payload" in opts:
            opts["payload"] = np.full((2, 2, 4), opts["payload"], np.float32)
        try:
            fut = srv.submit(seed, variant=variant, **opts)
        except mod.ServerOverloaded:
            outcomes.append("shed")
            continue
        if cancel:
            assert fut.cancel()
        futs.append(fut)
    time.sleep(0.05)  # past every max_wait and the 1 ms TTL
    with running(srv):
        for f in futs:
            try:
                f.result(timeout=WAIT)
                outcomes.append("ok")
            except TimeoutError:
                outcomes.append("expired")
            except Exception as e:  # noqa: BLE001 - the outcome is compared
                outcomes.append(type(e).__name__)
    snap = srv.stats.snapshot()
    counters = {k: v for k, v in snap.items() if k not in ("latency", "queue_wait")}
    return log, counters, snap["latency"]["count"], outcomes


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_dispatch_sequence_matches_jax_server(name):
    """The same groups, in the same order, with the same seeds, padding,
    class ids and guidance, negative and rescale rows and payloads; the
    same counters and outcomes."""
    want = run_script(jserving, name)
    got = run_script(serving, name)
    assert got == want
    assert got[0]  # something was dispatched


def test_prometheus_text_matches_jax():
    """The two Histograms (and ServerStats with gauges) given the same
    counts and latencies print the same Prometheus text and summaries."""
    lat = [0.0, 0.5, 1.0, 1.5, 2.0, 7.3, 19.9, 20.0, 480.0, 999.0, 1000.0, 4321.5,
           30000.0, 59999.0, 60000.0, 60001.0, 1e6]
    mine, theirs = serving.ServerStats(), jserving.ServerStats()
    for stats in (mine, theirs):
        stats.add(requests=17, batches=5, images=16, padded_images=3, shed=2,
                  expired=1, cancelled=1)
        for i, ms in enumerate(lat):
            stats.observe(ms, lat[-1 - i] / 7.0)
    gauges = {"ldm_queue_depth": 3, "ldm_queue_capacity": 1024}
    assert mine.prometheus(gauges) == theirs.prometheus(gauges)
    assert mine.snapshot() == theirs.snapshot()
    h, hj = serving.Histogram(), jserving.Histogram()
    assert h.prometheus_lines("x", "y") == hj.prometheus_lines("x", "y")
    assert h.summary() == hj.summary()


def test_server_prometheus_names_and_gauges():
    srv = SamplerServer(tiny_sample, batch_buckets=(1, 2), max_queue=7, device="cpu")
    srv.submit(1)
    text = srv.prometheus()
    for name in ("ldm_requests_total 1", "ldm_batches_total 0", "ldm_images_total 0",
                 "ldm_padded_images_total", "ldm_shed_total", "ldm_expired_total",
                 "ldm_cancelled_total", "ldm_mean_batch_size", "ldm_queue_depth 1",
                 "ldm_queue_capacity 7", 'ldm_request_latency_seconds_bucket{le="+Inf"} 0',
                 "ldm_queue_wait_seconds_count 0"):
        assert name in text, name


def test_build_parser_has_the_jax_options():
    options = lambda p: {s for a in p._actions for s in a.option_strings}
    assert options(serve.build_parser()) == options(jserve.build_parser())
    assert serve.build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("flags,match", [
    (["--coordinator", "h:1"], "needs all three of --coordinator"),
    (["--img2img-strength", "1.5"], r"must be in \[0, 1\]"),
    (["--guidance-scale", "3"], "requires --num-classes"),
    (["--step-tiers", "0"], "must be >= 1"),
])
def test_serve_main_checks_arguments(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve.main(["--config", "tiny", "-d", "cpu", *flags])


def test_server_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        SamplerServer(tiny_sample)


# -- the counterparts of tests/test_serving.py --------------------------------

def test_server_batches_and_resolves_all():
    srv = SamplerServer(tiny_sample, batch_buckets=(1, 2, 4), max_wait_ms=50, device="cpu")
    srv.warmup()  # the worker's contract: a list of seeds
    futs = [srv.submit(i) for i in range(10)]
    with running(srv):
        imgs = [f.result(timeout=WAIT) for f in futs]
    assert all(i.shape == (8, 8, 3) and i.dtype == np.uint8 for i in imgs)
    assert srv.stats.requests == 10 and srv.stats.images == 10
    assert srv.stats.batches == 3  # 4 + 4 + 2


def test_server_per_seed_determinism_across_batchings():
    srv1 = SamplerServer(tiny_sample, batch_buckets=(1, 2, 4), max_wait_ms=1, device="cpu")
    with running(srv1):
        alone = srv1.submit(7).result(timeout=WAIT)
    srv2 = SamplerServer(tiny_sample, batch_buckets=(4,), max_wait_ms=1, device="cpu")
    futs = [srv2.submit(s) for s in (1, 7, 3, 9)]
    with running(srv2):
        together = futs[1].result(timeout=WAIT)
    np.testing.assert_array_equal(alone, together)
    assert srv2.stats.batches == 1


def test_server_pads_partial_batches():
    seen = []
    srv = SamplerServer(lambda seeds, b: seen.append(list(seeds)) or tiny_sample(seeds, b),
                        batch_buckets=(4,), max_wait_ms=1, device="cpu")
    with running(srv):
        img = srv.submit(5).result(timeout=WAIT)
    assert img.shape == (8, 8, 3)
    assert srv.stats.padded_images == 3 and seen == [[5, 0, 0, 0]]


def test_server_propagates_errors():
    def bad(seeds, batch):
        raise RuntimeError("boom")

    srv = SamplerServer(bad, batch_buckets=(1,), max_wait_ms=1, device="cpu")
    with running(srv):
        with pytest.raises(RuntimeError, match="boom"):
            srv.submit(0).result(timeout=WAIT)


def test_server_multi_variant_routing():
    """One server, two image sizes: requests batch only with their own
    size and both variants resolve with their own shape."""
    def make(size):
        return lambda seeds, batch: torch.zeros((batch, size, size, 3), dtype=torch.uint8)

    srv = SamplerServer({8: make(8), 16: make(16)}, batch_buckets=(1, 2, 4),
                        max_wait_ms=1, device="cpu")
    futs8 = [srv.submit(i, variant=8) for i in range(3)]
    futs16 = [srv.submit(i, variant=16) for i in range(3)]
    futs8.append(srv.submit(9))  # the first key is the default
    with running(srv):
        i8 = [f.result(timeout=WAIT) for f in futs8]
        i16 = [f.result(timeout=WAIT) for f in futs16]
    assert all(i.shape == (8, 8, 3) for i in i8)
    assert all(i.shape == (16, 16, 3) for i in i16)
    assert srv.stats.batches == 2
    with pytest.raises(KeyError):
        srv.submit(0, variant=32)


def test_server_sheds_load_when_queue_full():
    srv = SamplerServer(tiny_sample, batch_buckets=(1,), max_wait_ms=1, max_queue=2,
                        device="cpu")
    futs = [srv.submit(i) for i in (1, 2)]  # no worker yet: the queue fills
    with pytest.raises(ServerOverloaded, match="admission share"):
        srv.submit(100)             # normal priority: its share is full too
    with pytest.raises(ServerOverloaded, match="queue full"):
        srv.submit(101, priority=0)
    assert srv.stats.shed == 2
    with running(srv):
        for f in futs:
            assert f.result(timeout=WAIT).shape == (8, 8, 3)


def test_server_ttl_expires_queued_requests():
    calls = []
    srv = SamplerServer(lambda s, b: calls.append(b) or tiny_sample(s, b),
                        batch_buckets=(1,), max_wait_ms=1, default_ttl_s=0.05,
                        device="cpu")
    stuck = srv.submit(1)
    time.sleep(0.1)  # past the TTL while queued
    with running(srv):
        with pytest.raises(TimeoutError):
            stuck.result(timeout=WAIT)
        fresh = srv.submit(2, ttl_s=WAIT)
        assert fresh.result(timeout=WAIT).shape == (8, 8, 3)
    assert srv.stats.expired == 1
    assert calls == [1]  # the expired request never burned a batch


def test_server_cancelled_future_skipped():
    seen = []
    srv = SamplerServer(lambda s, b: seen.append(list(s)) or tiny_sample(s, b),
                        batch_buckets=(1,), max_wait_ms=1, device="cpu")
    first = srv.submit(0)
    doomed = srv.submit(7)
    assert doomed.cancel()  # still queued -> cancellable
    with running(srv):
        assert first.result(timeout=WAIT).shape == (8, 8, 3)
    assert srv.stats.cancelled == 1
    assert seen == [[0]]


def test_server_stats_snapshot_and_histogram():
    srv = SamplerServer(tiny_sample, batch_buckets=(1, 2, 4), max_wait_ms=5, device="cpu")
    futs = [srv.submit(i) for i in range(5)]
    with running(srv):
        [f.result(timeout=WAIT) for f in futs]
    snap = srv.stats.snapshot()
    assert snap["requests"] == 5 and snap["images"] == 5
    assert snap["batches"] == 2 and snap["padded_images"] == 0  # 4 + 1
    assert snap["latency"]["count"] == 5
    assert snap["latency"]["p50_ms"] <= snap["latency"]["p99_ms"]
    assert sum(snap["latency"]["buckets"].values()) == 5
    assert snap["queue_wait"]["count"] == 5


def test_http_surface_end_to_end():
    """The real HTTP handler over a tiny sampler, hit concurrently."""
    srv = SamplerServer(tiny_sample, batch_buckets=(1, 2, 4), max_wait_ms=20, device="cpu")
    with http_server(srv) as port:
        results = []
        hit = lambda seed: results.append(fetch(port, f"/sample?seed={seed}"))
        threads = [threading.Thread(target=hit, args=(s,)) for s in range(6)]
        [x.start() for x in threads]
        [x.join(timeout=WAIT) for x in threads]
        assert not any(x.is_alive() for x in threads) and len(results) == 6
        for status, ctype, body in results:
            assert status == 200 and ctype == "image/jpeg"
            assert PIL.Image.open(io.BytesIO(body)).size == (8, 8)
        status, _, health = fetch(port, "/healthz")
        assert status == 200 and b'"ok": true' in health
        status, ctype, text = fetch(port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain") and b"ldm_images_total 6" in text
        assert fetch(port, "/nope")[0] == 404


def conditional_sample(seeds, batch, class_ids):
    """Stand-in with the conditional contract: pixel (0, 0, 0) is the
    request's class id."""
    imgs = torch.from_numpy(tiny_sample(seeds, batch) // 3)
    imgs[:, 0, 0, 0] = class_ids.to(torch.uint8)
    return imgs


def test_conditional_server_routes_class_ids():
    n_cls = 5
    srv = SamplerServer(conditional_sample, batch_buckets=(1, 2, 4), max_wait_ms=1,
                        num_classes=n_cls, device="cpu")
    srv.warmup()
    f_cond, f_uncond = srv.submit(1, class_id=3), srv.submit(2)
    with running(srv):
        img_c, img_u = f_cond.result(timeout=WAIT), f_uncond.result(timeout=WAIT)
    assert img_c[0, 0, 0] == 3 and img_u[0, 0, 0] == n_cls
    srv2 = SamplerServer(tiny_sample, batch_buckets=(1,), device="cpu")
    with pytest.raises(ValueError, match="unconditional"):
        srv2.submit(0, class_id=1)
    for bad in (n_cls, -1):
        with pytest.raises(ValueError, match="out of range"):
            srv.submit(0, class_id=bad)


def test_http_conditional_surface():
    srv = SamplerServer(conditional_sample, batch_buckets=(1, 2), max_wait_ms=5,
                        num_classes=4, device="cpu")
    with http_server(srv) as port:
        status, ctype, _ = fetch(port, "/sample?seed=1&class_id=2")
        assert status == 200 and ctype == "image/jpeg"
        status, _, body = fetch(port, "/sample?seed=1&class_id=99")
        assert status == 400 and b"out of range" in body
        assert fetch(port, "/sample?seed=1&class_id=abc")[0] == 400


@pytest.mark.parametrize("feature", ["guidance", "negative", "rescale"])
def test_row_variant_batching_and_validation(feature):
    """takes_guidance / takes_negative / takes_rescale variants receive
    each request's value as a per-sample row; requests without one (and
    padding) ride 1.0 / the null id / 0.0, so mixed requests share one
    batch; values the variant does not take, or out of range, are
    refused at submit."""
    n_cls = 4
    flags = dict(guidance=dict(takes_guidance=True),
                 negative=dict(takes_guidance=True, takes_negative=True),
                 rescale=dict(takes_guidance=True, takes_rescale=True))[feature]
    seen = []

    def fn(seeds, batch, class_ids, guidance_scales, *rows):
        row = {"guidance": guidance_scales}.get(feature, rows[0] if rows else None)
        seen.append(batch)
        return row_image(row, batch, 100.0 if feature == "rescale" else 1.0)

    srv = SamplerServer({"gen": conditional_sample, "cfg": Variant(fn, **flags)},
                        batch_buckets=(1, 2, 4), max_wait_ms=1, num_classes=n_cls,
                        device="cpu")
    srv.warmup()
    seen.clear()
    opts = dict(guidance=[dict(guidance=7.0), dict(guidance=9.0), {}],
                negative=[dict(guidance=3.0, negative_class=2),
                          dict(guidance=3.0, negative_class=0), dict(guidance=3.0)],
                rescale=[dict(guidance=3.0, cfg_rescale=0.7),
                         dict(guidance=3.0, cfg_rescale=0.25), dict(guidance=3.0)])[feature]
    futs = [srv.submit(i, variant="cfg", **o) for i, o in enumerate(opts)]
    with running(srv):
        a, b, c = (f.result(timeout=WAIT)[0, 0, 0] for f in futs)
    assert seen == [4]  # one batch, padded
    assert (a, b, c) == {"guidance": (7, 9, 1), "negative": (2, 0, n_cls),
                         "rescale": (70, 25, 0)}[feature]
    with pytest.raises(ValueError, match="does not take"):
        srv.submit(0, variant="gen", **opts[0])
    bad = {"guidance": [dict(guidance=float("nan"))],
           "negative": [dict(guidance=3.0, negative_class=n_cls),
                        dict(guidance=3.0, negative_class=-1)],
           "rescale": [dict(guidance=3.0, cfg_rescale=1.5),
                       dict(guidance=3.0, cfg_rescale=float("nan"))]}[feature]
    for o in bad:
        with pytest.raises(ValueError, match=r"non-finite|out of range|\[0, 1\]"):
            srv.submit(0, variant="cfg", **o)
    if feature == "negative":  # the null id needs num_classes
        with pytest.raises(AssertionError, match="takes_negative"):
            SamplerServer({"cfg": Variant(fn, takes_negative=True)}, device="cpu")


def test_payload_variant_batching_and_validation():
    def fn(seeds, batch, payload=None):
        # each request's payload mean as its pixels
        return row_image(torch.from_numpy(payload).mean(dim=(1, 2, 3)), batch)

    srv = SamplerServer({"gen": tiny_sample, "i2i": Variant(fn, payload_shape=(4, 4, 3))},
                        batch_buckets=(1, 2, 4), max_wait_ms=1, device="cpu")
    srv.warmup()
    f1 = srv.submit(1, variant="i2i", payload=np.full((4, 4, 3), 7.0))
    f2 = srv.submit(2, variant="i2i", payload=np.full((4, 4, 3), 9.0))
    f3 = srv.submit(3, variant="gen")
    with running(srv):
        a, b, c = (f.result(timeout=WAIT) for f in (f1, f2, f3))
    assert a[0, 0, 0] == 7 and b[0, 0, 0] == 9 and c.shape == (8, 8, 3)
    with pytest.raises(ValueError, match="needs a payload"):
        srv.submit(0, variant="i2i")
    with pytest.raises(ValueError, match="needs a payload"):
        srv.submit(0, variant="i2i", payload=np.zeros((2, 2, 3)))
    with pytest.raises(ValueError, match="does not take"):
        srv.submit(0, variant="gen", payload=np.zeros((4, 4, 3)))


def plain8(seeds, batch, class_ids=None):
    return torch.zeros((batch, 8, 8, 3), dtype=torch.uint8)


def rows_cfg(scale):
    """A CFG stand-in whose pixels read its last row (x scale)."""
    def fn(seeds, batch, class_ids, guidance_scales, *rows):
        return row_image(rows[-1] if rows else guidance_scales * 0 + 200, batch, scale)
    return fn


@pytest.mark.parametrize("case", ["guidance", "negative", "rescale"])
def test_http_guided_requests_route_by_cost(case):
    """guidance_scale != 1 routes to the ('cfg', size) variant, 1.0 or
    absent to the plain one; negative_class and cfg_rescale ride guided
    requests (an absent cfg_rescale: the server's default) and are 400
    at guidance 1.0 or out of range; malformed values are 400."""
    flags = dict(guidance={}, negative=dict(takes_negative=True),
                 rescale=dict(takes_rescale=True))[case]
    scale = dict(guidance=1.0, negative=50.0, rescale=100.0)[case]
    srv = SamplerServer({8: plain8, ("cfg", 8): Variant(rows_cfg(scale), takes_guidance=True,
                                                        **flags)},
                        batch_buckets=(1, 2), max_wait_ms=5, num_classes=4, device="cpu")
    g = "/sample?seed=1&class_id=2"
    checks = dict(
        guidance=[(g, 200, 0), (g + "&guidance_scale=1.0", 200, 0),
                  (g + "&guidance_scale=3.0", 200, 200), (g + "&guidance_scale=0.5", 200, 200),
                  ("/sample?seed=1&guidance_scale=abc", 400, None)],
        negative=[(g + "&guidance_scale=3.0&negative_class=2", 200, 100),
                  (g + "&guidance_scale=3.0", 200, 200),
                  (g + "&negative_class=2", 400, b"no effect"),
                  (g + "&guidance_scale=3.0&negative_class=9", 400, b"out of range")],
        rescale=[(g + "&guidance_scale=3.0&cfg_rescale=0.5", 200, 50),
                 (g + "&guidance_scale=3.0", 200, 25),
                 (g + "&cfg_rescale=0.5", 400, b"no effect"),
                 (g + "&guidance_scale=3.0&cfg_rescale=1.5", 400, b"[0, 1]")])[case]
    with http_server(srv, default_size=8, default_guidance=1.0,
                     default_rescale=0.25 if case == "rescale" else 0.0) as port:
        for path, status, want in checks:
            got, _, body = fetch(port, path)
            assert got == status, (path, body)
            if status == 200:
                assert abs(image_mean(body) - want) < 10, path
            elif want is not None:
                assert want in body, path


def test_http_guidance_without_cfg_variant_is_400():
    srv = SamplerServer({8: tiny_sample}, batch_buckets=(1,), max_wait_ms=5, device="cpu")
    with http_server(srv, default_size=8) as port:
        assert fetch(port, "/sample?seed=1&guidance_scale=2.0")[0] == 400


def png_with_dims(w, h):
    """A PNG header declaring w x h pixels with almost no data."""
    import struct
    import zlib

    out = b"\x89PNG\r\n\x1a\n"
    for tag, data in ((b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
                      (b"IDAT", zlib.compress(b"\x00")), (b"IEND", b"")):
        out += struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data))
    return out


def test_http_img2img_surface():
    got = {}

    def fn(seeds, batch, payload=None):
        got["payload"] = payload
        return plain8(seeds, batch)

    srv = SamplerServer({16: tiny_sample,
                         ("img2img", 16): Variant(fn, payload_shape=(16, 16, 4))},
                        batch_buckets=(1, 2), max_wait_ms=5, device="cpu")
    with http_server(srv, default_size=16) as port:
        buf = io.BytesIO()
        PIL.Image.fromarray(np.full((16, 16, 3), 200, np.uint8)).save(buf, format="PNG")
        body = json.dumps({"seed": 5, "image": base64.b64encode(buf.getvalue()).decode()})
        status, ctype, _ = fetch(port, "/img2img", "POST", body)
        assert status == 200 and ctype == "image/jpeg"
        # the decoded image reached the pipeline in [-1, 1], keep channel 0
        assert got["payload"].shape == (1, 16, 16, 4)
        assert abs(got["payload"][0, ..., :3].mean() - (200 / 127.5 - 1.0)) < 0.02
        assert not got["payload"][0, ..., 3].any()
        assert fetch(port, "/img2img", "POST", json.dumps({"seed": 1}))[0] == 400
        assert fetch(port, "/img2img", "POST",
                     json.dumps({"seed": 1, "image": "!!notb64!!"}))[0] == 400
        # an oversize declared body is 413 before the body is read
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
        try:
            conn.putrequest("POST", "/img2img")
            conn.putheader("Content-Length", str(64 * 1024 * 1024))
            conn.endheaders()
            r = conn.getresponse()
            assert r.status == 413
            r.read()
        finally:
            conn.close()
        # 100M declared pixels: the header-only dimension check's 413
        bomb = base64.b64encode(png_with_dims(10000, 10000)).decode()
        assert fetch(port, "/img2img", "POST",
                     json.dumps({"seed": 1, "image": bomb}))[0] == 413


def test_saturated_server_dispatches_full_buckets():
    """A backlog (32 requests from 32 threads, queued before the worker
    starts) is coalesced into full buckets, not dribbled out at batch 1."""
    srv = SamplerServer(tiny_sample, batch_buckets=(1, 2, 8), max_wait_ms=5, device="cpu")
    futs = []
    pool = [threading.Thread(target=lambda s=s: futs.append(srv.submit(s)))
            for s in range(32)]
    [t.start() for t in pool]
    [t.join(timeout=WAIT) for t in pool]
    assert not any(t.is_alive() for t in pool) and len(futs) == 32
    with running(srv):
        [f.result(timeout=WAIT) for f in futs]
        assert srv.sample_sync(99, timeout=WAIT).shape == (8, 8, 3)
    assert srv.stats.images == 33
    assert srv.stats.batches == 5, srv.stats.snapshot()


def test_priority_admission_shares():
    srv = SamplerServer(tiny_sample, batch_buckets=(1,), max_queue=10,
                        admit_fractions=(1.0, 0.8, 0.5), device="cpu")
    for i in range(5):
        srv.submit(i, priority=2)
    with pytest.raises(ServerOverloaded):
        srv.submit(99, priority=2)      # background beyond its 50% share
    for i in range(3):
        srv.submit(10 + i, priority=1)  # normal: share 8
    with pytest.raises(ServerOverloaded):
        srv.submit(99, priority=1)
    srv.submit(50, priority=0)
    srv.submit(51, priority=0)          # fills the queue to 10
    with pytest.raises(ServerOverloaded):
        srv.submit(52, priority=0)      # the hard bound applies to everyone
    with pytest.raises(ValueError):
        srv.submit(1, priority=3)
    assert srv.stats.shed == 3


def test_priority_orders_batch_slots():
    seen = []
    srv = SamplerServer(lambda s, b: seen.append(list(s)) or tiny_sample(s, b),
                        batch_buckets=(2,), max_wait_ms=1, device="cpu")
    futs = [srv.submit(101, priority=2), srv.submit(102, priority=2),
            srv.submit(103, priority=0)]
    with running(srv):
        [f.result(timeout=WAIT) for f in futs]
    # first pair: the interactive request + the oldest background one
    assert seen == [[103, 101], [102, 0]]


def test_http_sample_batch_streams_multipart():
    srv = SamplerServer(tiny_sample, batch_buckets=(1, 2, 4), max_wait_ms=20, device="cpu")
    with http_server(srv) as port:
        status, ctype, raw = fetch(port, "/sample_batch?seeds=3,9,5")
        assert status == 200 and ctype.startswith("multipart/mixed; boundary=")
        parts = multipart_parts(raw)
        assert len(parts) == 3
        for head, body in parts:
            assert head["Content-Type"] == "image/jpeg"
            assert PIL.Image.open(io.BytesIO(body)).size == (8, 8)
        assert {int(h["X-Seed"]) for h, _ in parts} == {3, 9, 5}
        status, _, raw = fetch(port, "/sample_batch?seed=100&n=2")
        assert status == 200 and raw.count(b"Content-Type: image/jpeg") == 2
        for bad in ("/sample_batch?seeds=,,", "/sample_batch?n=9999",
                    "/sample_batch?seeds=1,x"):
            assert fetch(port, bad)[0] == 400, bad


def test_http_sample_batch_timeout_ends_the_stream():
    """A /sample_batch whose batch outlives the handler's result timeout:
    one JSON error part naming the unfinished items, then the closing
    boundary; the items no dispatch has claimed yet (here the step
    tier's, queued behind the first item's variant) are cancelled and
    never run. The timeout defaults to 600 s."""
    assert inspect.signature(serve.make_handler).parameters["result_timeout"].default == 600
    release, seen, futs = threading.Event(), [], []

    def slow(seeds, batch):
        seen.append(list(seeds))
        release.wait(WAIT)
        return tiny_sample(seeds, batch)

    srv = SamplerServer({8: slow, ("steps", 5, 8): slow}, batch_buckets=(1,),
                        max_wait_ms=1, device="cpu")
    submit = srv.submit
    srv.submit = lambda *a, **k: futs.append(submit(*a, **k)) or futs[-1]
    items = [{"seed": 3}, {"seed": 9, "steps": 5}, {"seed": 5, "steps": 5}]
    try:
        with http_server(srv, default_size=8, step_tiers=(5,), default_steps=20,
                         result_timeout=0.5) as port:
            t0 = time.perf_counter()
            status, ctype, raw = fetch(port, "/sample_batch", "POST",
                                       json.dumps({"items": items}))
            waited = time.perf_counter() - t0
            release.set()
    finally:
        release.set()
    assert status == 200 and ctype.startswith("multipart/mixed") and waited < WAIT / 2
    assert raw.endswith(b"--ldmframe--\r\n")
    parts = multipart_parts(raw)
    assert len(parts) == 1
    head, body = parts[0]
    assert head["Content-Type"] == "application/json" and "X-Index" not in head
    err = json.loads(body)
    assert err["indices"] == [0, 1, 2] and err["error"].startswith("expired: 3 of 3")
    assert [f.cancelled() for f in futs] == [False, True, True]
    assert seen == [[3]] and srv.stats.cancelled == 2


def test_http_sample_batch_timeout_lists_every_item_not_written():
    """The items written before the deadline are not listed again; every
    other one is, here the step tier's two, which its dispatch claimed
    together (running: cancel() cannot stop them)."""
    release, seen, futs = threading.Event(), [], []

    def slow(seeds, batch):
        seen.append(list(seeds))
        release.wait(WAIT)
        return tiny_sample(seeds, batch)

    srv = SamplerServer({8: tiny_sample, ("steps", 5, 8): slow}, batch_buckets=(1,),
                        max_wait_ms=1, device="cpu")
    submit = srv.submit
    srv.submit = lambda *a, **k: futs.append(submit(*a, **k)) or futs[-1]
    items = [{"seed": 3}, {"seed": 9, "steps": 5}, {"seed": 5, "steps": 5}]
    try:
        with http_server(srv, default_size=8, step_tiers=(5,), default_steps=20,
                         result_timeout=2.0) as port:
            status, ctype, raw = fetch(port, "/sample_batch", "POST",
                                       json.dumps({"items": items}))
            release.set()
    finally:
        release.set()
    assert status == 200 and raw.endswith(b"--ldmframe--\r\n")
    (head0, body0), (head1, body1) = multipart_parts(raw)
    assert head0["X-Index"] == "0" and head0["X-Seed"] == "3"
    assert body0 == encode_jpeg(tiny_sample([3], 1)[0])
    err = json.loads(body1)
    assert err["indices"] == [1, 2] and err["error"].startswith("expired: 2 of 3")
    assert [f.cancelled() for f in futs] == [False, False, False]
    assert seen[0] == [9] and srv.stats.cancelled == 0


def test_http_step_tiers_route_by_cost():
    srv = SamplerServer({8: plain8, ("steps", 5, 8): lambda s, b: torch.full(
        (b, 8, 8, 3), 200, dtype=torch.uint8)}, batch_buckets=(1, 2), max_wait_ms=5,
        device="cpu")
    with http_server(srv, default_size=8, step_tiers=(5,), default_steps=20) as port:
        for path, dark in (("/sample?seed=1", True), ("/sample?seed=1&steps=20", True),
                           ("/sample?seed=1&steps=5", False)):
            status, _, body = fetch(port, path)
            assert status == 200 and (image_mean(body) < 50) == dark, path
        status, _, body = fetch(port, "/sample_batch?seeds=1,2&steps=5")
        assert status == 200 and body.count(b"Content-Type: image/jpeg") == 2
        status, _, body = fetch(port, "/sample?seed=1&steps=7")
        assert status == 400 and b"tiers" in body
        assert fetch(port, "/sample?seed=1&steps=abc")[0] == 400


def test_route_steps_img2img_rejected():
    handler = serve.make_handler(None, None, default_size=8, step_tiers=(5,),
                                 default_steps=20)
    with pytest.raises(ValueError, match="img2img"):
        handler._route(8, None, img2img=True, steps=5)
    # default steps on img2img is fine (it's a no-op)
    variant, gs, phi = handler._route(8, None, img2img=True, steps=20)
    assert (variant, gs, phi) == (("img2img", 8), None, None)
    assert handler._route(8, 3.0, img2img=True) == (("cfg", "img2img", 8), 3.0, None)


def test_parse_item_defaults_a_missing_seed_to_zero():
    handler = serve.make_handler(None, None)
    item = handler._parse_item({"class_id": "2"}, defaults={"guidance_scale": 3})
    assert item == dict(seed=0, size=None, class_id=2, guidance=3.0, rescale=None,
                        negative=None, steps=None, priority=1)


# -- end to end: make_variants and the HTTP handler against the JAX pipeline ----

CLASSES = 3
IMAGE = 16
LATENT = (8, 8, 8)


@pytest.fixture(scope="module")
def tiny_models():
    """(JAX pipeline, UNet and Decoder params, the port's pipeline holding
    the same weights, loaded through convert): tiny config, fp32, 3
    classes, routing pinned, v-prediction, the output layer damped (see
    tests/test_torch_port_cond.py)."""
    jcfg = JUNetConfig(num_classes=CLASSES, fixed_expert_indices=(0, 1)).tiny()
    jp = JPipeline(jcfg, JVAEConfig().tiny(), JDDPMConfig(prediction="v"),
                   dtype=jnp.float32)
    key = jax.random.PRNGKey(3)
    z0 = jnp.zeros((1,) + LATENT)
    up = jp.unet.init({"params": key, "moe": key}, z0, jnp.zeros((1,), jnp.int32))
    dp = jp.decoder.init(key, z0)
    up = jax.tree.map(np.asarray, up)
    up["params"]["decoder_last"]["kernel"] = up["params"]["decoder_last"]["kernel"] * 0.25
    dp = jax.tree.map(np.asarray, dp)
    ucfg = UNetConfig(num_classes=CLASSES, fixed_expert_indices=(0, 1)).tiny()
    pipe = LDMPipeline(unet_from_flax(up, ucfg, device="cpu"),
                       decoder_from_flax(dp, VAEConfig().tiny(), device="cpu"),
                       DDPMConfig(prediction="v"), dtype=torch.float32)
    return jp, jax.tree.map(jnp.asarray, up), jax.tree.map(jnp.asarray, dp), pipe


def jax_noise(seed, shape):
    """The JAX server's x_T draw for a seed."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)))


def test_served_images_match_the_jax_pipeline(tiny_models):
    """POST /sample_batch with unconditional items, guided items (scales
    3 and 5, a rescale, a negative class) and a step-tier item, PNG
    parts: each within 1 of JAX LDMPipeline.sample at the same bucket on
    the JAX server's x_T rows (padding seed 0)."""
    jp, up, dp, pipe = tiny_models
    variants, tiers = serve.make_variants(pipe, [IMAGE], num_steps=3, step_tiers=[2, 3],
                                          draw_noise=jax_noise)
    assert tiers == (2,)
    assert set(variants) == {IMAGE, ("cfg", IMAGE), ("steps", 2, IMAGE),
                             ("steps", 2, "cfg", IMAGE)}
    srv = SamplerServer(variants, batch_buckets=(1, 2, 4), max_wait_ms=1,
                        num_classes=CLASSES, device="cpu")
    items = [{"seed": 11}, {"seed": 12, "class_id": 1},
             {"seed": 21, "class_id": 0, "guidance_scale": 3.0},
             {"seed": 22, "class_id": 2, "guidance_scale": 3.0, "cfg_rescale": 0.7},
             {"seed": 23, "class_id": 1, "guidance_scale": 5.0, "negative_class": 0},
             {"seed": 31, "steps": 2}]
    groups = [  # (items, bucket, steps, class ids, guided rows or None)
        ([0, 1], 2, 3, [CLASSES, 1], None),
        ([2, 3, 4], 4, 3, [0, 2, 1, CLASSES],
         dict(guidance_scales=[3.0, 3.0, 5.0, 1.0], cfg_rescales=[0.0, 0.7, 0.0, 0.0],
              negative_condition=[CLASSES, CLASSES, 0, CLASSES])),
        ([5], 1, 2, [CLASSES], None)]
    out = {}
    with http_server(srv, encode=png_bytes, start=False, default_size=IMAGE,
                     step_tiers=tiers, default_steps=3, content_type="image/png") as port:
        call = threading.Thread(target=lambda: out.update(zip(
            ("status", "ctype", "raw"),
            fetch(port, "/sample_batch", "POST", json.dumps({"items": items})))))
        call.start()
        deadline = time.monotonic() + WAIT
        while srv.stats.requests < len(items) and time.monotonic() < deadline:
            time.sleep(0.01)
        srv.start()  # every item queued: the worker cuts the groups above
        call.join(timeout=WAIT)
        assert not call.is_alive()
    assert out["status"] == 200
    parts = {int(h["X-Index"]): (h, body) for h, body in multipart_parts(out["raw"])}
    assert sorted(parts) == list(range(len(items)))
    assert srv.stats.batches == 3 and srv.stats.padded_images == 1
    for idx, bucket, steps, ids, rows in groups:
        seeds = [items[i]["seed"] for i in idx] + [0] * (bucket - len(idx))
        noise = jnp.stack([jnp.asarray(jax_noise(s, LATENT).numpy()) for s in seeds])
        kw = {k: jnp.asarray(v) for k, v in (rows or {}).items()}
        want = np.asarray(jp.sample(up, dp, jax.random.PRNGKey(0), batch=bucket,
                                    image_size=IMAGE, num_steps=steps, init_noise=noise,
                                    condition=jnp.asarray(ids, jnp.int32), **kw))
        for row, i in enumerate(idx):
            head, body = parts[i]
            assert head["Content-Type"] == "image/png" and int(head["X-Seed"]) == seeds[row]
            got = np.asarray(PIL.Image.open(io.BytesIO(body)), np.int32)
            assert np.abs(got - want[row].astype(np.int32)).max() <= 1, (i, row)
