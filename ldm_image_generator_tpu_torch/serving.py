"""Serving: a dynamic-batching sampler daemon around LDMPipeline, the torch
counterpart of ldm_image_generator_tpu/serving.py.

Sampling throughput is won by batching, so the serving layer coalesces
concurrent requests into batches of a few fixed sizes:

  * Requests enqueue via submit() (thread-safe) and resolve as futures.
  * A worker thread drains the queue, rounds the group UP to the
    smallest batch bucket that fits and pads with seed-0 rows (3
    requests run as one batch-4 call); groups larger than the top bucket
    are split. warmup() runs every (variant, bucket) once.
  * max_wait_ms bounds the latency cost of waiting for a fuller batch:
    the worker takes what's there once the oldest request has waited
    long enough.

Production hardening:

  * **Multiple variants per server**: pass `{variant: sample_fn}` (e.g.
    one per image size) and route with submit(seed, variant=...). Each
    dispatch batches only same-variant requests; the worker serves the
    variant with the oldest waiting request first (no starvation).
  * **Load shedding**: the queue is bounded; when full, submit() raises
    ServerOverloaded immediately instead of blocking the caller; the
    HTTP layer maps it to 503 so clients can back off.
  * **Request TTL + cancellation**: submit(seed, ttl_s=...) expires
    requests still queued past their deadline (future gets
    TimeoutError); a future cancelled before dispatch is skipped. Both
    keep a dead client from burning a batch slot.
  * **Latency histograms**: ServerStats records per-request end-to-end
    latency and queue-wait in log-spaced buckets with percentile
    summaries for the /healthz /stats endpoints, and the Prometheus text
    of /metrics.
  * **Priority + admission control**: submit(seed, priority=0|1|2)
    (interactive/normal/background). Under load the queue stops
    admitting background work first (per-priority admission shares of
    queue capacity, `admit_fractions`), and within each dispatched
    group interactive requests take the batch slots first; the
    max-wait dispatch trigger stays oldest-request-based so no
    priority class starves.
  * **Class-conditional serving** (`num_classes=`): requests carry an
    optional class_id, batched as an int32 row alongside the seeds;
    requests without one (and batch padding) use the model's learned
    null embedding, so conditional and unconditional requests coalesce
    into the same batch.

The worker thread is the only caller of the variant functions. Each
dispatch builds its rows (class ids, guidance, negative and rescale) as
torch tensors on the server's device and resolves its futures to numpy
uint8 [H, W, 3] after one copy to the host. Run as an HTTP daemon via
cli/serve.py.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ldm_image_generator_tpu_torch.config import resolve_device
from ldm_image_generator_tpu_torch.utils import profiling


def as_numpy(imgs) -> np.ndarray:
    """A variant's images on the host as numpy (one copy for a tensor)."""
    if isinstance(imgs, torch.Tensor):
        return imgs.cpu().numpy()
    return np.asarray(imgs)


class ServerOverloaded(RuntimeError):
    """Raised by submit() when the request queue is full (shed load)."""


@dataclasses.dataclass(frozen=True)
class Variant:
    """A servable pipeline with optional per-request features.

    fn is called as fn(seeds, batch[, class_ids][, guidance_scales]
    [, negative_ids][, rescales][, payload=...]): seeds is the list of
    the batch's request seeds (padding 0); class_ids (int32 [batch])
    rides when the server has num_classes set; guidance_scales (f32
    [batch], when takes_guidance) carries each request's
    classifier-free-guidance strength as a per-sample row, so
    mixed-scale requests coalesce into the same batch (requests without
    one, and batch padding, ride as 1.0);
    negative_ids (int32 [batch], when takes_negative) carries each
    request's negative-class id for negative guidance; the null id
    (== num_classes) is a per-sample no-op, so requests with and
    without a negative prompt share the batch; rescales (f32 [batch],
    when takes_rescale) carries each request's CFG-rescale phi
    (arXiv:2305.08891 section 3.4); phi == 0 rows are exact plain CFG,
    so requests with and without a rescale share the batch too; payload
    (e.g. an img2img init image) when payload_shape is declared:
    requests to a payload variant MUST supply a payload of that
    per-request shape, which the worker stacks to
    [batch, *payload_shape] (zero rows pad). Every row tensor lies on
    the server's device. Bare callables passed to SamplerServer are
    wrapped as Variant(fn)."""

    fn: object
    payload_shape: Optional[Tuple[int, ...]] = None
    payload_dtype: object = np.float32
    takes_guidance: bool = False
    takes_negative: bool = False
    takes_rescale: bool = False


# _take_group's "nothing to dispatch" sentinel: must be distinct from
# every possible variant key (None is the default single-variant key)
_NO_WORK = object()


@dataclasses.dataclass
class _Request:
    seed: int
    variant: object
    future: Future
    enqueued_at: float
    deadline: Optional[float]  # monotonic seconds, None = no TTL
    claimed: bool = False      # future already moved to RUNNING
    class_id: Optional[int] = None  # conditional servers only
    payload: Optional[np.ndarray] = None  # payload variants only
    guidance: Optional[float] = None  # takes_guidance variants only
    negative: Optional[int] = None    # takes_negative variants only
    rescale: Optional[float] = None   # takes_rescale variants only
    priority: int = 1          # 0 = interactive .. 2 = background
    id: int = 0                # request number, for the spans
    queued_ns: int = 0         # profiling.now_ns() at submit, while recording


# Log-spaced latency bucket upper bounds (milliseconds). The last bucket
# is open-ended.
_HIST_EDGES_MS = (
    1, 2, 5, 10, 20, 50, 100, 200, 500,
    1000, 2000, 5000, 10000, 30000, 60000,
)


class Histogram:
    """Fixed log-bucket latency histogram (thread-safe via owner lock)."""

    def __init__(self):
        self.counts = [0] * (len(_HIST_EDGES_MS) + 1)
        self.total = 0
        self.sum_ms = 0.0

    def record(self, ms: float) -> None:
        self.counts[bisect.bisect_left(_HIST_EDGES_MS, ms)] += 1
        self.total += 1
        self.sum_ms += ms

    def percentile(self, q: float) -> float:
        """Approximate percentile: upper edge of the q-quantile bucket."""
        if not self.total:
            return 0.0
        target = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return float(_HIST_EDGES_MS[min(i, len(_HIST_EDGES_MS) - 1)])
        return float(_HIST_EDGES_MS[-1])

    def summary(self) -> dict:
        return {
            "count": self.total,
            "mean_ms": round(self.sum_ms / self.total, 2) if self.total else 0.0,
            "p50_ms": self.percentile(0.50),
            "p90_ms": self.percentile(0.90),
            "p99_ms": self.percentile(0.99),
            "buckets": {
                (f"le_{e}ms" if i < len(_HIST_EDGES_MS) else "inf"):
                    self.counts[i]
                for i, e in enumerate(
                    list(_HIST_EDGES_MS) + [_HIST_EDGES_MS[-1]]
                )
                if self.counts[i]
            },
        }

    def prometheus_lines(self, name: str, help_text: str) -> list:
        """Prometheus text-exposition histogram (cumulative buckets,
        base unit seconds per convention — edges are _HIST_EDGES_MS/1e3)."""
        lines = [f"# HELP {name} {help_text}",
                 f"# TYPE {name} histogram"]
        acc = 0
        for edge_ms, c in zip(_HIST_EDGES_MS, self.counts):
            acc += c
            lines.append(f'{name}_bucket{{le="{edge_ms / 1000.0}"}} {acc}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {self.total}')
        lines.append(f"{name}_sum {self.sum_ms / 1000.0}")
        lines.append(f"{name}_count {self.total}")
        return lines


@dataclasses.dataclass
class ServerStats:
    """Counters mutated from both the submit() callers and the worker
    thread — all writes go through add()/observe() under the lock
    (plain `+=` on a shared dataclass is a lost-update race)."""
    requests: int = 0
    batches: int = 0
    images: int = 0
    padded_images: int = 0
    shed: int = 0        # rejected at submit (queue full)
    expired: int = 0     # TTL passed while queued
    cancelled: int = 0   # future cancelled before dispatch

    def __post_init__(self):
        self._lock = threading.Lock()
        self.latency = Histogram()      # submit -> result, per request
        self.queue_wait = Histogram()   # submit -> dispatch, per request

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    def observe(self, latency_ms: float, wait_ms: float) -> None:
        with self._lock:
            self.latency.record(latency_ms)
            self.queue_wait.record(wait_ms)

    @property
    def mean_batch(self) -> float:
        return self.images / self.batches if self.batches else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests, "batches": self.batches,
                "images": self.images, "padded_images": self.padded_images,
                "shed": self.shed, "expired": self.expired,
                "cancelled": self.cancelled,
                "mean_batch": round(self.mean_batch, 2),
                "latency": self.latency.summary(),
                "queue_wait": self.queue_wait.summary(),
            }

    _PROM_COUNTERS = (
        ("requests", "ldm_requests_total",
         "requests accepted by submit()"),
        ("batches", "ldm_batches_total",
         "device batches dispatched"),
        ("images", "ldm_images_total",
         "real (non-padding) images produced"),
        ("padded_images", "ldm_padded_images_total",
         "padding slots burned rounding groups up to a bucket"),
        ("shed", "ldm_shed_total",
         "requests rejected at submit (queue full / admission share)"),
        ("expired", "ldm_expired_total",
         "requests whose TTL passed while queued"),
        ("cancelled", "ldm_cancelled_total",
         "futures cancelled before dispatch"),
    )

    def prometheus(self, gauges: Optional[dict] = None) -> str:
        """Prometheus text-exposition rendering of every counter and
        histogram (plus caller-supplied gauges, e.g. queue depth) — the
        /metrics scrape body. Same lock discipline as snapshot()."""
        with self._lock:
            lines = []
            for attr, name, help_text in self._PROM_COUNTERS:
                lines += [f"# HELP {name} {help_text}",
                          f"# TYPE {name} counter",
                          f"{name} {getattr(self, attr)}"]
            lines += ["# HELP ldm_mean_batch_size mean real images per "
                      "dispatched batch",
                      "# TYPE ldm_mean_batch_size gauge",
                      f"ldm_mean_batch_size {self.mean_batch}"]
            for key, val in (gauges or {}).items():
                lines += [f"# TYPE {key} gauge", f"{key} {val}"]
            lines += self.latency.prometheus_lines(
                "ldm_request_latency_seconds",
                "end-to-end latency, submit to result")
            lines += self.queue_wait.prometheus_lines(
                "ldm_queue_wait_seconds",
                "queue wait, submit to batch dispatch")
            return "\n".join(lines) + "\n"


class SamplerServer:
    """Dynamic-batching front-end over one or more pipeline sample fns.

    `pipelines` is either a single callable (one variant) or a dict
    `{variant: callable}`, e.g. `{256: sample_256, 512: sample_512}`
    for a multi-size server. Each callable has the contract
    `fn(seeds [batch ints], batch) -> uint8 images [batch, H, W, 3]` (a
    torch tensor or an array); batch is one of `batch_buckets`.
    Per-request seeds stay independent: the pipeline draws each image's
    x_T from its own seed (see cli/serve.py).
    """

    def __init__(
        self,
        pipelines: Union[Dict[object, object], object],
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        max_wait_ms: float = 25.0,
        max_queue: int = 1024,
        default_ttl_s: Optional[float] = None,
        num_classes: Optional[int] = None,
        admit_fractions: Sequence[float] = (1.0, 1.0, 0.5),
        device="cuda",
    ):
        """num_classes: serve a class-conditional model: every pipeline
        fn then takes (seeds, batch, class_ids int32 [batch]) and requests
        may carry class_id in [0, num_classes); requests without one (and
        batch padding) get the null id == num_classes (the model's
        learned unconditional embedding, models/unet.py class_embed).

        admit_fractions: per-priority admission shares of the queue
        (index = priority, 0 = most interactive). Under load the queue
        stops admitting background work first — priority p is shed once
        the queue holds >= admit_fractions[p] * max_queue requests — so
        bulk clients cannot crowd out interactive ones. Dispatch order
        within a cut batch group is (priority, arrival).

        device: where the per-batch rows are made (the pipeline's
        device); a CUDA request without a card raises."""
        if not isinstance(pipelines, dict):
            pipelines = {None: pipelines}
        assert pipelines, "need at least one pipeline variant"
        self._pipelines = {
            k: v if isinstance(v, Variant) else Variant(v)
            for k, v in pipelines.items()
        }
        self.num_classes = num_classes
        assert num_classes is not None or not any(
            v.takes_negative for v in self._pipelines.values()
        ), "takes_negative variants need num_classes (the null id)"
        self._default_variant = next(iter(self._pipelines))
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        assert self.buckets and self.buckets[0] >= 1
        self.admit_fractions = tuple(float(f) for f in admit_fractions)
        assert self.admit_fractions and all(
            0.0 < f <= 1.0 for f in self.admit_fractions
        )
        self.max_wait = max_wait_ms / 1000.0
        self.default_ttl = default_ttl_s
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.stats = ServerStats()
        self.device = resolve_device(device)
        self._request_ids = itertools.count(1)
        self._dispatches = 0  # the worker's own count, for the spans

    # -- lifecycle ---------------------------------------------------------
    def warmup(self) -> None:
        """Run every (variant, bucket) once, so the first requests find
        the pipelines' kernels built and their weights cast."""
        for v in self._pipelines.values():
            for b in self.buckets:
                payload = None
                if v.payload_shape is not None:
                    payload = np.zeros((b,) + tuple(v.payload_shape),
                                       v.payload_dtype)
                as_numpy(self._dispatch(v, list(range(b)), b, None, payload))

    def _row(self, values, dtype) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _dispatch(self, v: Variant, seeds, bucket, ids, payload,
                  guidance=None, negative=None, rescale=None):
        """Call a variant fn with exactly the features it declares.
        ids=None means all-null on conditional servers; guidance=None
        means all-1.0 on takes_guidance variants; negative=None means
        all-null on takes_negative variants; rescale=None means all-0.0
        (plain CFG) on takes_rescale variants."""
        args = [seeds, bucket]
        if self.num_classes is not None:
            if ids is None:
                ids = self._row([self.num_classes] * bucket, torch.int32)
            args.append(ids)
        if v.takes_guidance:
            if guidance is None:
                guidance = self._row([1.0] * bucket, torch.float32)
            args.append(guidance)
        if v.takes_negative:
            if negative is None:
                negative = self._row([self.num_classes] * bucket, torch.int32)
            args.append(negative)
        if v.takes_rescale:
            if rescale is None:
                rescale = self._row([0.0] * bucket, torch.float32)
            args.append(rescale)
        kwargs = {}
        if v.payload_shape is not None:
            kwargs["payload"] = payload
        return v.fn(*args, **kwargs)

    def start(self) -> "SamplerServer":
        assert self._worker is None, "already started"
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ---------------------------------------------------------
    def submit(self, seed: int, variant: object = None,
               ttl_s: Optional[float] = None,
               class_id: Optional[int] = None,
               payload: Optional[np.ndarray] = None,
               guidance: Optional[float] = None,
               negative_class: Optional[int] = None,
               cfg_rescale: Optional[float] = None,
               priority: int = 1) -> Future:
        """Enqueue one image request; resolves to uint8 [H, W, 3].

        Raises ServerOverloaded when the queue is full (load shedding;
        callers/HTTP map this to 503 + retry-after) or when the request's
        priority class is beyond its admission share of the queue
        (admit_fractions). KeyError for an unknown variant; ValueError
        for a class_id on an unconditional server or out of range, for a
        missing/mis-shaped payload on a payload variant, for a guidance
        scale on a variant that does not take one (or a non-finite one),
        for a cfg_rescale outside [0, 1] or on a variant that does not
        take one, or for a priority outside [0, len(admit_fractions)).
        ttl_s (or
        the server default) bounds queue time: expired requests resolve
        to TimeoutError without burning a batch slot. Cancelling the
        returned future before dispatch also frees the slot. priority
        orders requests within a dispatched group (0 = interactive
        first) and picks the admission share; it does not preempt an
        already-running batch.
        """
        if variant is None:
            variant = self._default_variant
        if variant not in self._pipelines:
            raise KeyError(
                f"unknown variant {variant!r}; have {list(self._pipelines)}"
            )
        v = self._pipelines[variant]
        if v.payload_shape is not None:
            want = tuple(v.payload_shape)
            if payload is None or tuple(np.shape(payload)) != want:
                raise ValueError(
                    f"variant {variant!r} needs a payload of shape "
                    f"{want}, got "
                    f"{None if payload is None else np.shape(payload)}"
                )
            payload = np.asarray(payload, v.payload_dtype)
        elif payload is not None:
            raise ValueError(
                f"variant {variant!r} does not take a payload"
            )
        if guidance is not None:
            if not v.takes_guidance:
                raise ValueError(
                    f"variant {variant!r} does not take a guidance scale"
                )
            guidance = float(guidance)
            if not np.isfinite(guidance):
                raise ValueError(f"non-finite guidance scale {guidance}")
        if cfg_rescale is not None:
            if not v.takes_rescale:
                raise ValueError(
                    f"variant {variant!r} does not take a cfg_rescale"
                )
            cfg_rescale = float(cfg_rescale)
            if not (np.isfinite(cfg_rescale) and 0.0 <= cfg_rescale <= 1.0):
                raise ValueError(
                    f"cfg_rescale must be in [0, 1], got {cfg_rescale}"
                )
        if negative_class is not None:
            if not v.takes_negative:
                raise ValueError(
                    f"variant {variant!r} does not take a negative class"
                )
            if not 0 <= int(negative_class) < (self.num_classes or 0):
                raise ValueError(
                    f"negative_class {negative_class} out of range "
                    f"[0, {self.num_classes})"
                )
            negative_class = int(negative_class)
        if class_id is not None:
            if self.num_classes is None:
                raise ValueError(
                    "class_id given but this server is unconditional "
                    "(start it with num_classes=...)"
                )
            if not 0 <= int(class_id) < self.num_classes:
                raise ValueError(
                    f"class_id {class_id} out of range "
                    f"[0, {self.num_classes})"
                )
            class_id = int(class_id)
        priority = int(priority)
        if not 0 <= priority < len(self.admit_fractions):
            raise ValueError(
                f"priority {priority} out of range "
                f"[0, {len(self.admit_fractions)})"
            )
        share = int(self._q.maxsize * self.admit_fractions[priority])
        if priority > 0 and self._q.qsize() >= share:
            # admission control: lower priorities stop being admitted
            # while capacity above their share remains reserved for
            # more interactive traffic (qsize is approximate under
            # concurrency — the reserve is a soft bound, the hard bound
            # below still applies to everyone)
            self.stats.add(shed=1)
            raise ServerOverloaded(
                f"queue beyond priority-{priority} admission share "
                f"({share} of {self._q.maxsize})"
            )
        fut: Future = Future()
        ttl = ttl_s if ttl_s is not None else self.default_ttl
        # stamped before the monotonic clock: a queue span is never
        # shorter than the wait _take_group measured
        queued_ns = profiling.now_ns() if profiling.recording() else 0
        now = time.monotonic()
        req = _Request(int(seed), variant, fut, now,
                       now + ttl if ttl is not None else None,
                       class_id=class_id, payload=payload,
                       guidance=guidance, negative=negative_class,
                       rescale=cfg_rescale, priority=priority,
                       id=next(self._request_ids), queued_ns=queued_ns)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.stats.add(shed=1)
            raise ServerOverloaded(
                f"queue full ({self._q.maxsize} pending)"
            ) from None
        self.stats.add(requests=1)
        return fut

    def sample_sync(self, seed: int, timeout: Optional[float] = None,
                    variant: object = None):
        return self.submit(seed, variant=variant).result(timeout=timeout)

    def prometheus(self) -> str:
        """Prometheus text exposition for GET /metrics: all ServerStats
        counters/histograms plus live queue gauges."""
        return self.stats.prometheus(gauges={
            "ldm_queue_depth": self._q.qsize(),
            "ldm_queue_capacity": self._q.maxsize,
        })

    # -- worker --------------------------------------------------------------
    def _reap(self, reqs) -> list:
        """Drop expired/cancelled requests; return the live ones.

        A request that survives is "claimed" (its future moves to
        RUNNING, so client cancel() can no longer race the dispatch);
        claimed requests left over from a previous oversize group are
        not re-claimed, but their TTL still applies while they wait.
        """
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                try:
                    r.future.set_exception(
                        TimeoutError("request expired in queue (ttl)")
                    )
                    self.stats.add(expired=1)
                except InvalidStateError:  # client cancelled it first
                    self.stats.add(cancelled=1)
                continue
            if not r.claimed:
                if not r.future.set_running_or_notify_cancel():
                    self.stats.add(cancelled=1)
                    continue
                r.claimed = True
            live.append(r)
        return live

    def _take_group(self, pending: Dict[object, list]) -> object:
        """Pull requests into per-variant pending lists until some
        variant is dispatchable (full top bucket, or its oldest request
        has waited max_wait). Returns the variant key to dispatch, or
        _NO_WORK (idle poll — a variant key itself may be None)."""
        top = self.buckets[-1]
        while True:
            # drain everything already queued FIRST (non-blocking).
            # Without this, a saturated server dribbles out batch-1
            # dispatches: while a batch computes, requests age past
            # max_wait in the queue, and a taker that returned after one
            # pull would dispatch each of them alone.
            try:
                while True:
                    r = self._q.get_nowait()
                    pending.setdefault(r.variant, []).append(r)
            except queue.Empty:
                pass
            # dispatch when: some variant fills the top bucket, or the
            # globally-oldest request has waited max_wait
            ready = None
            oldest_deadline = None
            for v, reqs in pending.items():
                if not reqs:
                    continue
                if len(reqs) >= top:
                    return v
                d = reqs[0].enqueued_at + self.max_wait
                if oldest_deadline is None or d < oldest_deadline:
                    oldest_deadline, ready = d, v
            now = time.monotonic()
            if oldest_deadline is not None and now >= oldest_deadline:
                return ready
            timeout = (
                min(oldest_deadline - now, 0.1)
                if oldest_deadline is not None else 0.1
            )
            try:
                r = self._q.get(timeout=timeout)
                pending.setdefault(r.variant, []).append(r)
            except queue.Empty:
                if oldest_deadline is None:
                    return _NO_WORK  # idle; let _run re-check stop flag

    def _bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, else the largest bucket."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run(self) -> None:
        pending: Dict[object, list] = {}
        while True:
            have_pending = any(pending.values())
            if self._stop.is_set() and not have_pending and self._q.empty():
                break
            with profiling.span("serve.take"):
                variant = self._take_group(pending)
            if variant is _NO_WORK:
                continue
            reqs = self._reap(pending[variant])
            if not reqs:
                pending[variant] = []
                continue
            # interactive-first within the group cut; stable sort keeps
            # arrival order within a priority class (no starvation: the
            # max_wait trigger in _take_group is oldest-request-based
            # regardless of priority, and leftovers lead the next cut)
            reqs.sort(key=lambda r: (r.priority, r.enqueued_at))
            bucket = self._bucket_for(len(reqs))
            group, pending[variant] = reqs[:bucket], reqs[bucket:]
            self._dispatches += 1
            self._serve(variant, group, bucket, self._dispatches)

    def _serve(self, variant, group: list, bucket: int, n: int) -> None:
        """Dispatch one group (padded to `bucket`) and resolve its futures;
        n numbers the dispatch in the spans: serve.dispatch (children
        serve.rows, serve.to_host, serve.resolve), and per request
        serve.queue (submit to dispatch) and serve.service (dispatch to its
        result)."""
        pad = bucket - len(group)
        dispatch_at = time.monotonic()
        traced = profiling.recording()
        dispatch_ns = profiling.now_ns() if traced else 0
        seeds = [r.seed for r in group] + [0] * pad
        v = self._pipelines[variant]
        try:
            with profiling.span("serve.dispatch", dispatch=n, bucket=bucket,
                                real=len(group), variant=variant):
                with profiling.span("serve.rows"):
                    ids = None
                    if self.num_classes is not None:
                        # None / padding -> the null (unconditional) id
                        null = self.num_classes
                        ids = self._row(
                            [null if r.class_id is None else r.class_id
                             for r in group] + [null] * pad, torch.int32)
                    payload = None
                    if v.payload_shape is not None:
                        zero = np.zeros(tuple(v.payload_shape),
                                        v.payload_dtype)
                        payload = np.stack(
                            [r.payload for r in group] + [zero] * pad
                        )
                    guidance = None
                    if v.takes_guidance:
                        # per-request scales ride as a row; None and
                        # padding are 1.0 (plain conditional sampling)
                        guidance = self._row(
                            [1.0 if r.guidance is None else r.guidance
                             for r in group] + [1.0] * pad, torch.float32)
                    negative = None
                    if v.takes_negative:
                        # None / padding -> the null id (plain CFG baseline)
                        null = self.num_classes
                        negative = self._row(
                            [null if r.negative is None else r.negative
                             for r in group] + [null] * pad, torch.int32)
                    rescale = None
                    if v.takes_rescale:
                        # None / padding -> phi 0.0 (exact plain CFG)
                        rescale = self._row(
                            [0.0 if r.rescale is None else r.rescale
                             for r in group] + [0.0] * pad, torch.float32)
                out = self._dispatch(v, seeds, bucket, ids, payload,
                                     guidance, negative, rescale)
                with profiling.span("serve.to_host"):
                    imgs = as_numpy(out)
                self.stats.add(batches=1, images=len(group),
                               padded_images=pad)
                done = time.monotonic()
                with profiling.span("serve.resolve"):
                    for r, img in zip(group, imgs):
                        r.future.set_result(img)
                        self.stats.observe(
                            (done - r.enqueued_at) * 1e3,
                            (dispatch_at - r.enqueued_at) * 1e3,
                        )
                        if traced:
                            profiling.record("serve.service", dispatch_ns,
                                             profiling.now_ns(), request=r.id,
                                             dispatch=n)
        except Exception as e:  # pragma: no cover - propagate to callers
            for r in group:
                r.future.set_exception(e)
        finally:
            if traced:
                for r in group:
                    if r.queued_ns:
                        profiling.record("serve.queue", r.queued_ns, dispatch_ns,
                                         request=r.id, dispatch=n)
