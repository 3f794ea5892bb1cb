"""Serving daemon: HTTP front-end over the dynamic-batching sampler, the
torch counterpart of ldm_image_generator_tpu/cli/serve.py.

    python -m ldm_image_generator_tpu_torch.cli.serve -dp ddpm.pt \\
        -decp vae_decoder.pt --port 8080 --buckets 1 2 4 8

    GET  /healthz                          -> {"ok": true, stats...}
    GET  /stats                            -> full counters + latency
                                              histograms (p50/p90/p99)
    GET  /metrics                          -> Prometheus text exposition
    GET  /sample?seed=123[&size=512][&class_id=7][&guidance_scale=3.0]
                 [&cfg_rescale=0.7][&negative_class=2]
                 [&priority=high|normal|low][&steps=10]
                                           -> image/jpeg
    GET  /sample_batch?seeds=1,2,3 | seed=40&n=8  [+ the same options]
                                           -> multipart/mixed stream, one
                                              image part per seed (X-Seed
                                              header) in completion order
    POST /sample  {"seed": 123, "size": 512, "class_id": 7, ...}
                                           -> image/jpeg
    POST /sample_batch {"items": [{"seed": 1, "class_id": 3},
                                  {"seed": 2, "guidance_scale": 2.0},
                                  ...], ...per-request defaults}
                       | {"seeds": [1, 2, 3], ...shared options}
                                           -> multipart/mixed stream
                                              (X-Index + X-Seed parts) of
                                              a heterogeneous batch
    POST /img2img {"seed": 1, "image": "<base64>"[, "size", "class_id",
                   "guidance_scale", "cfg_rescale", "priority"]}
                                           -> image/jpeg (needs
                                              --img2img-strength > 0)

The options mean what they mean in the JAX package's server: class_id
needs --num-classes (omitted: the learned null class); guidance_scale
routes by cost (1.0 to the single-UNet variant, anything else to the CFG
variant, where scales, cfg_rescale and negative_class ride as per-sample
rows, so mixed values share a batch; cfg_rescale and negative_class at
guidance 1.0 are 400); steps picks a tier of --step-tiers (400 outside
them and for img2img); priority orders batch slots and sets the
admission share. A full queue is 503, an expired request 504, a bad
argument 400, a failed batch 500.

Each request's x_T (its img2img forward noise) is draw_noise(seed): a CPU
torch.Generator seeded with the request's seed draws it in fp32, so a
request's noise depends neither on the device nor on its batch. The same
seed gives another image than the JAX server's (threefry draws other
numbers). The routing generator is a fresh one seeded 0 per dispatch.
Weights load from flax parameter files (-dp, -decp, -encp) as the
sampling CLI's do; a missing path means seeded weights. Runs on `cuda`
unless `-d cpu` is given. An img2img payload is [S, S, 4]: the image in
[-1, 1] and a keep channel, 0 (regenerate) for HTTP requests; a caller of
SamplerServer.submit may set it to 1 where the input is to be kept
(inpainting, DDIM only).
"""
from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ldm_image_generator_tpu_torch.cli.common import add_launch_args
from ldm_image_generator_tpu_torch.cli.sample_ldm import build_pipeline, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LDM sampling daemon (PyTorch/CUDA port)")
    p.add_argument("-dp", "--ddpmpath", default="./ddpm.pt")
    p.add_argument("-decp", "--decpath", default="./vae_decoder.pt")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    # the JAX CLI's launch flags: each process forms the group and serves
    # on its own card, cuda:(rank % device_count)
    add_launch_args(p)
    p.add_argument("-fp16", default=True, type=str2bool,
                   help="bfloat16 compute (false: float32)")
    p.add_argument("-s", "--size", nargs="+", default=[256], type=int,
                   help="image size(s) to serve; first is the default")
    p.add_argument("-t", "--timesteps", default=20, type=int)
    p.add_argument("--step-tiers", nargs="+", type=int, default=None,
                   help="additional per-request sampler step counts served "
                        "alongside --timesteps (e.g. '10' adds a fast preview "
                        "tier); requests select one with steps=N")
    p.add_argument("--sampler", default="ddim", choices=["ddim", "dpm++2m"])
    p.add_argument("--cache-interval", default=1, type=int,
                   help="DeepCache for the non-guided sample variants (plain "
                        "DDIM only): recompute the UNet's deep core every N "
                        "steps (1 = off)")
    p.add_argument("--port", default=8080, type=int)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--buckets", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--max-wait-ms", default=25.0, type=float)
    p.add_argument("--max-queue", default=1024, type=int,
                   help="pending-request bound; beyond it submit sheds load "
                        "(HTTP 503)")
    p.add_argument("--ttl-s", default=None, type=float,
                   help="drop requests queued longer than this (HTTP 504)")
    p.add_argument("--config", default="default", choices=["default", "tiny"])
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: per-output-column quantized FFN weights")
    p.add_argument("--num-classes", default=0, type=int,
                   help="serve a class-conditional model: requests may pass "
                        "class_id (0..N-1); omitted = the learned null class")
    p.add_argument("--guidance-scale", default=1.0, type=float,
                   help="default guidance strength for requests that pass "
                        "none (1 = off; != 1 requires --num-classes)")
    p.add_argument("--cfg-rescale", default=0.0, type=float,
                   help="default guidance rescale phi for guided requests "
                        "that pass no cfg_rescale")
    p.add_argument("--img2img-strength", default=0.0, type=float,
                   help="also serve POST /img2img at this strength (0 = off)")
    p.add_argument("-encp", "--encpath", default="./vae_encoder.pt",
                   help="VAE encoder parameter file (img2img serving only)")
    p.add_argument("--prediction", default="eps", choices=["eps", "v"])
    p.add_argument("--zero-snr", action="store_true",
                   help="zero terminal SNR schedule; needs --prediction v")
    return p


def draw_noise(seed: int, shape):
    """A request's N(0, 1) noise: fp32 from a CPU generator seeded with
    its seed, so it is the same on every device and in every batch."""
    import torch

    return torch.randn(shape, generator=torch.Generator().manual_seed(int(seed)))


def make_variants(pipe, sizes, num_steps: int = 20, sampler: str = "ddim",
                  cache_interval: int = 1, step_tiers=(),
                  img2img_strength: float = 0.0, draw_noise=draw_noise):
    """({variant key: variant}, served step tiers) over one pipeline: per
    size the plain sampler; with a class-conditional UNet ("cfg", size)
    taking per-sample guidance, negative and rescale rows; ("steps", n,
    size) (and ("steps", n, "cfg", size)) per extra step tier; with
    img2img_strength > 0 ("img2img", size) (and ("cfg", "img2img",
    size)) taking [size, size, 4] payloads: the image in [-1, 1] and a
    keep channel (1 keeps that pixel's input, inpainting with DDIM only;
    a batch whose keep channels are all 0, padding included, samples
    without a mask). Each function draws its rows' x_T (img2img: forward
    noise) with draw_noise(seed, shape) and samples under a fresh routing
    generator seeded 0."""
    import torch

    from ldm_image_generator_tpu_torch.serving import Variant
    from ldm_image_generator_tpu_torch.utils.profiling import span

    dev = pipe.device
    down = pipe.decoder.cfg.downscale
    channels = pipe.unet.cfg.input_channels
    noise_shape = lambda size: (size // down, size // down, channels)

    def rows(seeds, size):
        # each row's noise drawn on the host, then one copy to the device
        with span("serve.noise", rows=len(seeds)):
            return torch.stack([draw_noise(s, noise_shape(size)) for s in seeds]).to(dev)

    routing = lambda: torch.Generator(device=dev).manual_seed(0)

    def make_for_size(size: int, n: int = num_steps):
        def pipeline_sample(seeds, batch, class_ids=None):
            return pipe.sample(routing(), batch=batch, image_size=size, num_steps=n,
                               sampler=sampler, init_noise=rows(seeds, size),
                               condition=class_ids,
                               cache_interval=cache_interval if sampler == "ddim" else 1)
        return pipeline_sample

    def make_cfg_for_size(size: int, n: int = num_steps):
        def pipeline_cfg(seeds, batch, class_ids, guidance_scales, negative_ids,
                         rescales):
            return pipe.sample(routing(), batch=batch, image_size=size, num_steps=n,
                               sampler=sampler, init_noise=rows(seeds, size),
                               condition=class_ids, guidance_scales=guidance_scales,
                               cfg_rescales=rescales, negative_condition=negative_ids)
        return Variant(pipeline_cfg, takes_guidance=True, takes_negative=True,
                       takes_rescale=True)

    def make_img2img_for_size(size: int, cfg: bool):
        def pipeline_img2img(seeds, batch, class_ids=None, guidance_scales=None,
                             negative_ids=None, rescales=None, payload=None):
            keep = payload[..., 3:]
            mask = None if (keep == 0.0).all() else torch.from_numpy(1.0 - keep)
            return pipe.img2img(
                torch.from_numpy(payload[..., :3]), routing(),
                strength=img2img_strength, num_steps=num_steps, sampler=sampler,
                mask=mask, condition=class_ids, fwd_noise=rows(seeds, size),
                guidance_scales=guidance_scales, cfg_rescales=rescales,
                negative_condition=negative_ids)

        if cfg:
            return Variant(pipeline_img2img, payload_shape=(size, size, 4),
                           takes_guidance=True, takes_negative=True,
                           takes_rescale=True)

        def pipeline_plain(seeds, batch, class_ids=None, payload=None):
            return pipeline_img2img(seeds, batch, class_ids, payload=payload)
        return Variant(pipeline_plain, payload_shape=(size, size, 4))

    conditional = pipe.unet.cfg.num_classes > 0
    variants = {s: make_for_size(s) for s in sizes}
    if conditional:
        for s in sizes:
            variants[("cfg", s)] = make_cfg_for_size(s)
    tiers = tuple(sorted(set(step_tiers or []) - {num_steps}))
    for n in tiers:
        for s in sizes:
            variants[("steps", n, s)] = make_for_size(s, n)
            if conditional:
                variants[("steps", n, "cfg", s)] = make_cfg_for_size(s, n)
    if img2img_strength > 0:
        for s in sizes:
            variants[("img2img", s)] = make_img2img_for_size(s, cfg=False)
            if conditional:
                variants[("cfg", "img2img", s)] = make_img2img_for_size(s, cfg=True)
    return variants, tiers


def make_handler(server, encode, default_size=None, default_guidance=1.0,
                 step_tiers=(), default_steps=None, default_rescale=0.0,
                 content_type="image/jpeg", result_timeout=600.0):
    """The BaseHTTPRequestHandler class of the endpoints above over
    `server`; encode(uint8 [H, W, 3]) -> bytes of `content_type`.
    result_timeout: seconds a request waits for its image (504), or a
    /sample_batch for all of its images (a JSON error part, the
    unfinished items cancelled)."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _route(size, guidance, img2img=False, steps=None,
                   negative=None, rescale=None):
            """(variant key, guidance-or-None, rescale-or-None): bucketing
            by cost. Guidance scale 1.0 (after defaulting) rides the
            single-eval variant, anything else the CFG variant; a
            non-default `steps` routes to that tier's variants. ValueError
            for a steps value the server does not serve, for steps on
            img2img, and for negative_class or an explicit cfg_rescale at
            scale 1 (they would have no effect)."""
            gs = default_guidance if guidance is None else guidance
            use_cfg = gs != 1.0
            if negative is not None and not use_cfg:
                raise ValueError(
                    "negative_class has no effect at guidance_scale 1.0 "
                    "— pass guidance_scale != 1"
                )
            if rescale is not None and not use_cfg:
                raise ValueError(
                    "cfg_rescale has no effect at guidance_scale 1.0 "
                    "— pass guidance_scale != 1"
                )
            phi = default_rescale if rescale is None else rescale
            size_eff = size if size is not None else default_size
            if steps is not None and steps == default_steps:
                steps = None  # the default tier keeps the bare keys
            if steps is not None and steps not in step_tiers:
                raise ValueError(
                    f"steps={steps} is not served; tiers: "
                    f"{sorted(set(step_tiers) | ({default_steps} if default_steps else set()))}"
                )
            if img2img:
                if steps is not None:
                    raise ValueError(
                        "steps tiers are not available for img2img "
                        "(the SDEdit sub-schedule is set by the "
                        "server's --img2img-strength)"
                    )
                variant = (("cfg", "img2img", size_eff) if use_cfg
                           else ("img2img", size_eff))
            elif steps is not None:
                variant = (("steps", steps, "cfg", size_eff) if use_cfg
                           else ("steps", steps, size_eff))
            else:
                variant = ("cfg", size_eff) if use_cfg else size
            # phi 0.0 is an exact no-op -> ride as None
            return (variant, (gs if use_cfg else None),
                    (phi if use_cfg and phi != 0.0 else None))

        def _send_503(self, e):
            self.send_response(503)
            body = json.dumps({"error": str(e)}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After", "1")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _sample(self, seed: int, size=None, class_id=None,
                    payload=None, img2img=False, guidance=None,
                    priority=1, steps=None, negative=None,
                    rescale=None):
            # every failure maps to an HTTP status, never a dropped
            # connection: 503 shed, 504 ttl-expired, 400 bad argument,
            # 500 anything else
            from ldm_image_generator_tpu_torch.serving import ServerOverloaded

            try:
                variant, gs, phi = self._route(size, guidance, img2img,
                                               steps, negative, rescale)
                fut = server.submit(seed, variant=variant,
                                    class_id=class_id, payload=payload,
                                    guidance=gs, negative_class=negative,
                                    cfg_rescale=phi, priority=priority)
            except ServerOverloaded as e:
                return self._send_503(e)
            except (KeyError, ValueError) as e:
                return self._send(
                    400, json.dumps({"error": str(e)}).encode()
                )
            try:
                img = fut.result(timeout=result_timeout)
            except TimeoutError as e:
                return self._send(
                    504, json.dumps({"error": f"expired: {e}"}).encode()
                )
            except Exception as e:
                return self._send(
                    500,
                    json.dumps({"error": f"sampling failed: {e}"}).encode(),
                )
            self._send(200, encode(img), content_type)

        MAX_BATCH_SEEDS = 64

        def _sample_batch(self, items):
            """Submit every item up front (they coalesce into full device
            batches) and write each image as a multipart/mixed part the
            moment its future resolves. Each item (seed/size/class_id/
            guidance/steps/negative/rescale/priority) routes on its own;
            items on the same cost bucket share device batches. Parts
            carry X-Index (position in the request) and X-Seed; a failed
            item becomes an application/json part. Close-delimited body:
            the terminating boundary ends the stream. Items unfinished
            after result_timeout are cancelled (those no dispatch has
            claimed yet never run) and reported in one JSON part, {"error", "indices"},
            before the terminating boundary."""
            from concurrent.futures import as_completed

            from ldm_image_generator_tpu_torch.serving import ServerOverloaded

            futs = {}
            try:
                for i, it in enumerate(items):
                    variant, gv, phi = self._route(
                        it.get("size"), it.get("guidance"),
                        steps=it.get("steps"),
                        negative=it.get("negative"),
                        rescale=it.get("rescale"))
                    futs[server.submit(
                        it["seed"], variant=variant,
                        class_id=it.get("class_id"), guidance=gv,
                        negative_class=it.get("negative"),
                        cfg_rescale=phi,
                        priority=it.get("priority", 1),
                    )] = (i, it["seed"])
            except ServerOverloaded as e:
                for f in futs:
                    f.cancel()
                return self._send_503(e)
            except (KeyError, ValueError) as e:
                for f in futs:
                    f.cancel()
                return self._send(
                    400, json.dumps({"error": str(e)}).encode()
                )
            boundary = "ldmframe"
            self.send_response(200)
            self.send_header("Content-Type",
                             f"multipart/mixed; boundary={boundary}")
            self.send_header("Connection", "close")
            self.end_headers()
            def part(ctype, body, head=""):
                self.wfile.write(
                    f"--{boundary}\r\nContent-Type: {ctype}\r\n{head}"
                    f"Content-Length: {len(body)}\r\n\r\n".encode())
                self.wfile.write(body)
                self.wfile.write(b"\r\n")
                self.wfile.flush()

            sent = set()  # the indices written as a part
            try:
                try:
                    for fut in as_completed(list(futs), timeout=result_timeout):
                        index, seed = futs[fut]
                        try:
                            body = encode(fut.result())
                            ctype = content_type
                        except Exception as e:
                            body = json.dumps({"index": index, "seed": seed,
                                               "error": str(e)}).encode()
                            ctype = "application/json"
                        part(ctype, body, f"X-Index: {index}\r\nX-Seed: {seed}\r\n")
                        sent.add(index)
                except TimeoutError:
                    # every item not written yet, those that finished
                    # since the deadline too
                    late = sorted(i for i, _ in futs.values() if i not in sent)
                    for f in futs:
                        f.cancel()
                    part("application/json", json.dumps(
                        {"error": f"expired: {len(late)} of {len(futs)} items "
                                  f"unfinished after {result_timeout} s",
                         "indices": late}).encode())
                self.wfile.write(f"--{boundary}--\r\n".encode())
            except (BrokenPipeError, ConnectionError, OSError):
                # client went away: free the undispatched slots
                for f in futs:
                    f.cancel()

        _PRIORITY_NAMES = {"interactive": 0, "high": 0, "normal": 1,
                           "low": 2, "background": 2, "batch": 2}

        @classmethod
        def _parse_priority(cls, raw):
            """0|1|2 or a name; None -> normal (1)."""
            if raw is None:
                return 1
            if isinstance(raw, str) and raw.strip().lower() in \
                    cls._PRIORITY_NAMES:
                return cls._PRIORITY_NAMES[raw.strip().lower()]
            return int(raw)

        @staticmethod
        def _parse_size(raw):
            """Optional-int parse (size, class_id): None passes through
            (server default / unconditional); raises ValueError."""
            return int(raw) if raw is not None else None

        @classmethod
        def _parse_item(cls, obj, defaults=None):
            """One request's options (JSON body object or already-parsed
            values) -> the _sample_batch item dict. Missing keys fall back
            to `defaults` (the request-level options), then to the server
            defaults; a missing seed is 0. Raises ValueError/TypeError on
            malformed values (mapped to 400 by the callers)."""
            d = defaults or {}

            def pick(key):
                v = obj.get(key)
                return v if v is not None else d.get(key)

            raw_gs = pick("guidance_scale")
            raw_phi = pick("cfg_rescale")
            return {
                "seed": int(obj.get("seed", 0)),
                "size": cls._parse_size(pick("size")),
                "class_id": cls._parse_size(pick("class_id")),
                "guidance": float(raw_gs) if raw_gs is not None else None,
                "rescale": float(raw_phi) if raw_phi is not None else None,
                "negative": cls._parse_size(pick("negative_class")),
                "steps": cls._parse_size(pick("steps")),
                "priority": cls._parse_priority(pick("priority")),
            }

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                s = server.stats
                self._send(200, json.dumps({
                    "ok": True, "requests": s.requests,
                    "batches": s.batches, "images": s.images,
                    "mean_batch": round(s.mean_batch, 2),
                }).encode())
            elif url.path == "/stats":
                self._send(
                    200, json.dumps(server.stats.snapshot()).encode()
                )
            elif url.path == "/sample":
                q = parse_qs(url.query)
                try:
                    seed = int(q.get("seed", ["0"])[0])
                    size = self._parse_size(q.get("size", [None])[0])
                    cid = self._parse_size(q.get("class_id", [None])[0])
                    raw_gs = q.get("guidance_scale", [None])[0]
                    gs = float(raw_gs) if raw_gs is not None else None
                    raw_phi = q.get("cfg_rescale", [None])[0]
                    phi = float(raw_phi) if raw_phi is not None else None
                    neg = self._parse_size(
                        q.get("negative_class", [None])[0])
                    nst = self._parse_size(q.get("steps", [None])[0])
                    prio = self._parse_priority(
                        q.get("priority", [None])[0])
                except ValueError as e:
                    return self._send(
                        400, json.dumps({"error": f"bad arg: {e}"}).encode()
                    )
                self._sample(seed, size, cid, guidance=gs, priority=prio,
                             steps=nst, negative=neg, rescale=phi)
            elif url.path == "/sample_batch":
                q = parse_qs(url.query)
                try:
                    if "seeds" in q:
                        seeds = [int(s) for s in q["seeds"][0].split(",")
                                 if s.strip()]
                    else:
                        base = int(q.get("seed", ["0"])[0])
                        seeds = list(range(
                            base, base + int(q.get("n", ["1"])[0])))
                    if not 1 <= len(seeds) <= self.MAX_BATCH_SEEDS:
                        raise ValueError(
                            f"need 1..{self.MAX_BATCH_SEEDS} seeds, "
                            f"got {len(seeds)}")
                    size = self._parse_size(q.get("size", [None])[0])
                    cid = self._parse_size(q.get("class_id", [None])[0])
                    raw_gs = q.get("guidance_scale", [None])[0]
                    gs = float(raw_gs) if raw_gs is not None else None
                    raw_phi = q.get("cfg_rescale", [None])[0]
                    phi = float(raw_phi) if raw_phi is not None else None
                    neg = self._parse_size(
                        q.get("negative_class", [None])[0])
                    nst = self._parse_size(q.get("steps", [None])[0])
                    prio = self._parse_priority(
                        q.get("priority", [None])[0])
                except ValueError as e:
                    return self._send(
                        400, json.dumps({"error": f"bad arg: {e}"}).encode()
                    )
                item = {"size": size, "class_id": cid, "guidance": gs,
                        "steps": nst, "negative": neg, "rescale": phi,
                        "priority": prio}
                self._sample_batch([dict(item, seed=s) for s in seeds])
            elif url.path == "/metrics":
                self._send(200, server.prometheus().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._send(404, b'{"error": "not found"}')

        # A single request must not be able to exhaust host memory: cap
        # the declared body size before reading it (16MB covers any sane
        # base64 image payload) and bound the decoded image dimensions
        # before the full pixel decode.
        MAX_BODY_BYTES = 16 * 1024 * 1024
        MAX_IMAGE_PIXELS = 64 * 1024 * 1024  # 8k x 8k

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/sample", "/img2img", "/sample_batch"):
                return self._send(404, b'{"error": "not found"}')
            n = int(self.headers.get("Content-Length", 0))
            if n > self.MAX_BODY_BYTES:
                return self._send(413, json.dumps(
                    {"error": f"body too large ({n} bytes > "
                              f"{self.MAX_BODY_BYTES})"}).encode())
            if url.path == "/sample_batch":
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if "items" in body:
                        raw_items = body["items"]
                        if not isinstance(raw_items, list) or not all(
                                isinstance(o, dict) for o in raw_items):
                            raise ValueError(
                                "items must be a list of objects")
                    else:
                        raw_items = [{"seed": s} for s in body["seeds"]]
                    if not 1 <= len(raw_items) <= self.MAX_BATCH_SEEDS:
                        raise ValueError(
                            f"need 1..{self.MAX_BATCH_SEEDS} items, "
                            f"got {len(raw_items)}")
                    items = [self._parse_item(o, defaults=body)
                             for o in raw_items]
                except (KeyError, ValueError, TypeError) as e:
                    return self._send(400, json.dumps(
                        {"error": f"bad request: {e}"}).encode())
                return self._sample_batch(items)
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                seed = int(body.get("seed", 0))
                size = self._parse_size(body.get("size"))
                cid = self._parse_size(body.get("class_id"))
                raw_gs = body.get("guidance_scale")
                gs = float(raw_gs) if raw_gs is not None else None
                raw_phi = body.get("cfg_rescale")
                phi = float(raw_phi) if raw_phi is not None else None
                neg = self._parse_size(body.get("negative_class"))
                nst = self._parse_size(body.get("steps"))
                prio = self._parse_priority(body.get("priority"))
                payload = None
                if url.path == "/img2img":
                    # {"image": base64 of any image format PIL reads}
                    import base64

                    import numpy as np
                    from PIL import Image

                    from ldm_image_generator_tpu_torch.data.dataset import (
                        preprocess_image,
                    )

                    raw = base64.b64decode(body["image"])
                    # header-only open to reject decompression bombs
                    # before the pixel decode; PIL's own bomb error is a
                    # 413 too
                    try:
                        with Image.open(io.BytesIO(raw)) as im:
                            w, h = im.size
                    except Image.DecompressionBombError:
                        return self._send(413, json.dumps(
                            {"error": "image too large"}).encode())
                    if w * h > self.MAX_IMAGE_PIXELS:
                        return self._send(413, json.dumps(
                            {"error": f"image too large ({w}x{h})"}
                        ).encode())
                    image = preprocess_image(
                        io.BytesIO(raw),
                        size if size is not None else default_size,
                        use_native=False)  # PIL, as the JAX server decodes uploads
                    # the keep channel: regenerate the whole image
                    payload = np.concatenate(
                        [image, np.zeros(image.shape[:2] + (1,), image.dtype)], -1)
            except (KeyError, ValueError, TypeError, AttributeError,
                    OSError) as e:
                return self._send(
                    400, json.dumps({"error": f"bad request: {e}"}).encode()
                )
            self._sample(seed, size, cid, payload,
                         img2img=url.path == "/img2img", guidance=gs,
                         priority=prio, steps=nst, negative=neg,
                         rescale=phi)

    return Handler


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not 0.0 <= args.img2img_strength <= 1.0:
        raise SystemExit("--img2img-strength must be in [0, 1]")
    if args.guidance_scale != 1.0 and not args.num_classes:
        raise SystemExit("--guidance-scale != 1 requires --num-classes "
                         "(CFG guides against the learned null class)")
    if args.step_tiers and any(t < 1 for t in args.step_tiers):
        raise SystemExit("--step-tiers must be >= 1")
    import numpy as np
    from PIL import Image

    from ldm_image_generator_tpu_torch.serving import SamplerServer

    # seeded weights (seed 0) where a parameter file does not exist
    pipe = build_pipeline(args, 0, args.img2img_strength > 0)
    variants, step_tiers = make_variants(
        pipe, list(args.size), num_steps=args.timesteps, sampler=args.sampler,
        cache_interval=args.cache_interval, step_tiers=args.step_tiers,
        img2img_strength=args.img2img_strength)
    server = SamplerServer(variants, batch_buckets=args.buckets,
                           max_wait_ms=args.max_wait_ms,
                           max_queue=args.max_queue,
                           default_ttl_s=args.ttl_s,
                           num_classes=args.num_classes or None,
                           device=pipe.device)
    print(f"warmup: variants {list(variants)} x buckets {args.buckets}", flush=True)
    server.warmup()
    server.start()

    def jpeg_encode(img) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(np.asarray(img)).save(buf, format="JPEG", quality=95)
        return buf.getvalue()

    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(server, jpeg_encode, args.size[0],
                     default_guidance=args.guidance_scale,
                     step_tiers=step_tiers,
                     default_steps=args.timesteps,
                     default_rescale=args.cfg_rescale),
    )
    print(f"serving on http://{args.host}:{args.port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
