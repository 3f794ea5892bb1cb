"""Closed-loop class-conditional sampling of a DiT configuration: one
client calls the port's LDMPipeline.sample (the DiT in the UNet's place)
back to back at the mix's batch, each call with its own init noise and
class ids (uniform over the configuration's classes), both drawn from the
seed; the images go to the host. After the window, rows of calls drawn
from the seed among the finished ones are sampled again by the plain
reference (portbench/reference/dit.py) and decoded by the reference
decoder; the numbers and their limits are drivers/sample.py's."""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from portbench import compare, harness, program_dit
from portbench import weights as W
from portbench.drivers import sample as base
from portbench.harness import Outcome, Run
from portbench.reference import dit as refdit
from portbench.reference import unet as ref
from portbench.trace import WINDOW, Profile, Spans
from portbench.work import latent_side

# seconds between the profiler's start and the window's first marker: the
# profiler drops as out of range the device records of its first ~2 ms
# (their device timestamps fall before its start on its own clock), and a
# marker launched at once onto an idle card is among them
SETTLE_S = 0.05


def call_inputs(r: Run, i: int):
    """(init noise [B, h, w, C] float32 on the host, class ids [B] int64)
    of call i."""
    cfg, b = r.cfg, r.traffic["batch"]
    g = torch.Generator().manual_seed((int(r.seed) * 1000003 + 17 * i + 5) % (2 ** 63 - 1))
    lat = latent_side(cfg)
    noise = torch.randn((b, lat, lat, cfg["dit"]["in_channels"]), generator=g)
    return noise, torch.randint(0, cfg["dit"]["num_classes"], (b,), generator=g)


def profile_window(spans: Spans) -> Profile:
    """trace.Profile entered (as its __enter__ does), with SETTLE_S between
    the profiler's start and the window's first marker."""
    from torch.profiler import ProfilerActivity, profile

    prof = Profile(spans)
    prof._prof = profile(activities=[ProfilerActivity.CUDA])
    prof._prof.__enter__()
    time.sleep(SETTLE_S)
    spans.enabled = True
    spans.mark("begin", WINDOW)
    return prof


def run(r: Run) -> Outcome:
    if r.int8:
        raise ValueError("a DiT has no int8 FFN weights")
    dev, cfg, tr = r.device, r.cfg, r.traffic
    spans = Spans()
    pipe, dit = program_dit.pipeline(cfg, r.seed, dev)
    harness.phase(r, "built")
    b, guidance = tr["batch"], cfg["guidance_scale"]

    def call(i):
        noise, classes = call_inputs(r, i)
        with spans.span("sample", batch=b):
            imgs, z = pipe.sample(None, batch=b, image_size=cfg["image_size"],
                                  num_steps=cfg["num_steps"], init_noise=noise,
                                  condition=classes.to(dev), guidance_scale=guidance,
                                  return_latent=True)
        return imgs.cpu().numpy(), z.cpu()

    call(-1)  # warm-up at the window's shapes
    harness.phase(r, "warmed")
    attention_calls = dit.attention_calls
    setup_s = time.time() - r.started
    prof = profile_window(spans) if r.trace else None
    outs = []
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < r.seconds:
            outs.append(call(len(outs)))
        elapsed = time.perf_counter() - t0
    finally:
        if prof:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = prof.reduce() if prof else None
    attention_calls = dit.attention_calls - attention_calls
    metrics = {"setup_s": setup_s, "images_per_s": b * len(outs) / elapsed}
    counters = {"calls": len(outs), "images": b * len(outs), "batch": b,
                "guided": guidance != 1.0, "attention_calls": attention_calls}
    print(f"dit_sample: {len(outs)} calls of {b} in {elapsed:.3f} s, "
          f"{attention_calls} attention calls", flush=True)
    del pipe, dit
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(r, outs)
    counters["numbers"] = numbers
    return Outcome(metrics=metrics, attempted=len(outs), failed=0,
                   checks=compare.limited(numbers, r.limits), memory_peak_bytes=peak,
                   counters=counters, trace=trace)


def reference_calls(r: Run, idx, rounding=None, block: int = 4) -> list:
    """[(uint8 images, final latents)] of the reference for the compared
    rows of calls idx, `block` rows at a time; rounding: every product of
    the sampler and the decoder rounded by it (the control)."""
    cfg, dev = r.cfg, r.device
    dt = getattr(torch, cfg["compute_dtype"])
    P = {n: t.float() for n, t in W.make(refdit.shapes(cfg["dit"]), r.seed, "unet", dev,
                                         dt).items()}
    D = base.reference_decoder(r)
    d = cfg["ddpm"]
    ab = refdit.alpha_bar(d["beta_min"], d["beta_max"], d["num_timesteps"])
    out = []
    for i in idx:
        noise, classes = call_inputs(r, i)
        sel = base.rows(r, i)
        imgs, lats = [], []
        for lo in range(0, len(sel), block):
            rows = sel[lo:lo + block]
            with ref.RoundedProducts(rounding) if rounding else contextlib.nullcontext():
                z = refdit.sample(P, cfg["dit"], noise[rows].to(dev), classes[rows].to(dev),
                                  cfg["guidance_scale"], cfg["num_steps"], ab)
                imgs.append(ref.to_uint8(ref.decoder(D, cfg["vae"], z)).cpu())
            lats.append(z.cpu())
        out.append((torch.cat(imgs).numpy(), torch.cat(lats)))
    return out


def check(r: Run, outs: list) -> dict:
    """drivers/sample.py's numbers (images, final latents, the decoder
    alone) of the compared rows of `check_calls` finished calls drawn from
    the seed, against the reference's of the same inputs."""
    if not outs:
        return {}
    refdit.precise()
    idx = base.pick(r, len(outs))
    got = [(outs[i][0][base.rows(r, i)], outs[i][1][base.rows(r, i)]) for i in idx]
    return base.numbers(r, got, reference_calls(r, idx))


def control(r: Run) -> dict:
    """The numbers of the control: the reference with its products in fp8
    in the program's place, on calls a run of this seed makes."""
    refdit.precise()
    idx = base.pick(r, 8)
    return base.numbers(r, reference_calls(r, idx, rounding=refdit.control_rounding(r.cfg)),
                        reference_calls(r, idx))
