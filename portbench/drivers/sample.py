"""Closed-loop sampling: one client calls the port's LDMPipeline.sample
back to back at the mix's batch, each call with its own init noise,
class ids (drawn uniformly from the configuration's classes) and routing
generator, all drawn from the seed; the images go to the host. After the
window, calls drawn from the seed among the finished ones are sampled
again by the reference."""
from __future__ import annotations

import gc
import time

import torch

from portbench import compare, harness, program, schedule
from portbench import weights as W
from portbench.harness import Outcome, Run
from portbench.reference import sample as refs
from portbench.reference import unet as ref
from portbench.trace import Profile, Spans
from portbench.work import latent_side


def call_inputs(r: Run, i: int):
    """(init noise [B, h, w, C] float32 on the host, class ids [B] int64 or
    None, routing seed) of call i."""
    cfg, b = r.cfg, r.traffic["batch"]
    g = torch.Generator().manual_seed((int(r.seed) * 1000003 + 17 * i + 5) % (2 ** 63 - 1))
    lat = latent_side(cfg)
    noise = torch.randn((b, lat, lat, cfg["unet"]["input_channels"]), generator=g)
    classes = None
    if cfg["unet"]["num_classes"] > 0:
        classes = torch.randint(0, cfg["unet"]["num_classes"], (b,), generator=g)
    return noise, classes, int(torch.randint(0, 2 ** 62, (1,), generator=g))


def run(r: Run) -> Outcome:
    dev, cfg, tr = r.device, r.cfg, r.traffic
    spans = Spans()
    pipe, unet = program.pipeline(cfg, r.seed, dev, int8=r.int8)
    harness.phase(r, "built")
    unet_calls = [0]
    unet.register_forward_pre_hook(lambda *_: unet_calls.__setitem__(0, unet_calls[0] + 1))
    b, guidance = tr["batch"], cfg["guidance_scale"]

    def call(i):
        noise, classes, rseed = call_inputs(r, i)
        with spans.span("sample", batch=b):
            imgs, z = pipe.sample(torch.Generator(device=dev).manual_seed(rseed), batch=b,
                                  image_size=cfg["image_size"], num_steps=cfg["num_steps"],
                                  init_noise=noise,
                                  condition=None if classes is None else classes.to(dev),
                                  guidance_scale=guidance, return_latent=True)
        return imgs.cpu().numpy(), z.cpu()

    call(-1)  # warm-up at the window's shapes (and the FiLM schedule)
    harness.phase(r, "warmed")
    unet_calls[0] = 0
    setup_s = time.time() - r.started
    prof = Profile(spans) if r.trace else None
    outs = []
    if prof:
        prof.__enter__()
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
    metrics = {"setup_s": setup_s, "images_per_s": b * len(outs) / elapsed}
    counters = {"calls": len(outs), "images": b * len(outs), "unet_calls": unet_calls[0],
                "batch": b, "guided": guidance != 1.0 and cfg["unet"]["num_classes"] > 0}
    print(f"sample: {len(outs)} calls of {b} in {elapsed:.3f} s, "
          f"{unet_calls[0]} UNet calls", flush=True)
    del pipe, unet
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(r, outs)
    counters["numbers"] = numbers
    checks = compare.limited(numbers, r.limits)
    return Outcome(metrics=metrics, attempted=len(outs), failed=0, checks=checks,
                   memory_peak_bytes=peak, counters=counters, trace=trace)


def rows(r: Run, i: int) -> list:
    """The rows of call i that the check compares: `check_rows` of the
    batch, drawn from the seed (rows are independent: each has its own
    noise and class, all share the call's routing plans)."""
    g = schedule.rng(r.seed, 3 + i)
    b = r.traffic["batch"]
    return sorted(int(j) for j in g.choice(b, size=min(r.traffic["check_rows"], b),
                                           replace=False))


def reference_decoder(r: Run) -> dict:
    cfg = r.cfg
    return {n: t.float() for n, t in W.make(ref.decoder_shapes(cfg["vae"]), r.seed, "decoder",
                                            r.device, getattr(torch, cfg["compute_dtype"])).items()}


def reference_calls(r: Run, idx, rounding=None) -> list:
    """[(uint8 images, final latents)] of the reference for the compared
    rows of calls idx."""
    cfg, dev = r.cfg, r.device
    dt = getattr(torch, cfg["compute_dtype"])
    P = {n: t.float() for n, t in W.make(ref.unet_shapes(cfg["unet"]), r.seed, "unet", dev,
                                         dt).items()}
    D = reference_decoder(r)
    out = []
    for i in idx:
        noise, classes, rseed = call_inputs(r, i)
        sel = rows(r, i)
        imgs, z = refs.images(P, D, cfg, noise[sel].to(dev), rseed,
                              None if classes is None else classes[sel],
                              cfg["guidance_scale"], rounding=rounding)
        out.append((imgs.numpy(), z))
    return out


def pick(r: Run, n: int) -> list:
    g = schedule.rng(r.seed, 2)
    return sorted(int(i) for i in g.choice(n, size=min(r.traffic["check_calls"], n),
                                           replace=False))


def numbers(r: Run, got: list, want: list) -> dict:
    """img_mean_abs etc. (images against the reference's), img_latent_rel
    (final latents), img_decode_abs (the images against the reference
    decoder's of the same latents: the decoder alone)."""
    D = reference_decoder(r)
    return compare.image_numbers([
        dict(refs.gaps(g[0], w[0]), latent_rel=refs.latent_gap(g[1], w[1]),
             decode_abs=refs.gaps(g[0], refs.decode(D, r.cfg, g[1]))["mean_abs"])
        for g, w in zip(got, want)])


def check(r: Run, outs: list) -> dict:
    """compare.image_numbers (and the final latents' relative gap) of the
    compared rows of `check_calls` finished calls drawn from the seed,
    against the reference's of the same inputs."""
    if not outs:
        return {}
    ref.precise()
    idx = pick(r, len(outs))
    got = [(outs[i][0][rows(r, i)], outs[i][1][rows(r, i)]) for i in idx]
    return numbers(r, got, reference_calls(r, idx))


def control(r: Run) -> dict:
    """The numbers of the control: the reference with its products in fp8
    in the program's place, on calls a run of this seed makes."""
    ref.precise()
    idx = pick(r, 8)
    return numbers(r, reference_calls(r, idx, rounding=ref.control_rounding(r.cfg)),
                   reference_calls(r, idx))
