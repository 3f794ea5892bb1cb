"""Back-to-back train steps of the port's make_ldm_train_step. Every step
takes new rows drawn from the seed on the device: latents, timesteps,
noise, the MoE routing plan and the stochastic-depth keeps. Set-up
builds the train state, runs the first `check_steps` steps through the
window's own call and feed, reads what the check compares (each step's
loss, the first gradient from AdamW's first moment, the parameters' and
the EMA's change after the last), and hands the same state to the
window. The reference then follows those steps from the same weights
and rows."""
from __future__ import annotations

import gc
import time

import torch

from portbench import compare, harness, program
from portbench import weights as W
from portbench.harness import Outcome, Run
from portbench.reference import train as reft
from portbench.reference import unet as ref
from portbench.trace import Profile, Spans
from portbench.work import latent_side

B1 = 0.9  # AdamW's b1: the first moment after one step is (1 - b1) g


def feeder(r: Run):
    """feed() -> the next step's (x, t, eps, plan, keeps), drawn on the
    device from a generator seeded with the run's seed."""
    cfg, dev, b = r.cfg, r.device, r.traffic["batch"]
    lat = latent_side(cfg)
    shape = (b, lat, lat, cfg["unet"]["input_channels"])
    n_pairs = len(ref.pair_table(cfg["unet"]["num_experts"]))
    n_blocks = len(ref.blocks(cfg["unet"]))
    g = torch.Generator(device=dev).manual_seed((int(r.seed) * 7919 + 3) % (2 ** 63 - 1))

    def feed():
        x = torch.randn(shape, generator=g, device=dev)
        t = torch.randint(1, cfg["ddpm"]["num_timesteps"], (b,), generator=g, device=dev)
        eps = torch.randn(shape, generator=g, device=dev)
        plan = torch.randint(0, n_pairs, (n_blocks,), generator=g, device=dev)
        keeps = torch.rand((n_blocks,), generator=g, device=dev) > cfg["unet"]["stochastic_depth"]
        return x, t, eps, plan, keeps
    return feed


def run(r: Run) -> Outcome:
    dev, cfg, tr = r.device, r.cfg, r.traffic
    spans = Spans()
    step, state, unet = program.trainer(cfg, tr, r.seed, dev, int8=r.int8)
    harness.phase(r, "built")
    names = [n for n, _ in unet.named_parameters()]
    feed = feeder(r)
    prog = {"losses": []}
    for k in range(tr["check_steps"]):
        state, loss = step(state, *feed())
        prog["losses"].append(float(loss))
        harness.phase(r, f"check step {k + 1}")
        if k == 0:
            mu = state.opt_state.mu
            prog["grad_norms"] = {n: float(m.norm()) / (1 - B1) for n, m in zip(names, mu)}
    with torch.no_grad():
        p0 = W.make(ref.unet_shapes(cfg["unet"]), r.seed, "unet", dev,
                    getattr(torch, cfg["param_dtype"]))
        params = dict(unet.named_parameters())
        prog["change_norms"] = {n: float((params[n] - p0[n]).norm()) for n in names}
        prog["ema_change_norms"] = {n: float((state.ema_params[n] - p0[n]).norm())
                                    for n in names}
        del p0, params
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - r.started
    prof = Profile(spans) if r.trace else None
    steps = 0
    if prof:
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < r.seconds:
            with spans.span("step"):
                state, _ = step(state, *feed())
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
    finally:
        if prof:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = prof.reduce() if prof else None
    b = tr["batch"]
    metrics = {"setup_s": setup_s, "train_images_per_s": b * steps / elapsed}
    counters = {"steps": steps, "batch": b}
    print(f"train: {steps} steps of {b} in {elapsed:.3f} s", flush=True)
    del state, step, unet
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(r, prog)
    counters["numbers"] = numbers
    checks = compare.limited(numbers, r.limits)
    return Outcome(metrics=metrics, attempted=steps, failed=0, checks=checks,
                   memory_peak_bytes=peak, counters=counters, trace=trace)


def check(r: Run, prog: dict) -> dict:
    """compare.train_numbers of the program's first steps against the
    reference's steps from the same weights and rows."""
    ref.precise()
    cfg = r.cfg
    P = W.make(ref.unet_shapes(cfg["unet"]), r.seed, "unet", r.device,
               getattr(torch, cfg["param_dtype"]))
    P = {n: t.float() for n, t in P.items()}
    feed = feeder(r)
    feeds = [feed() for _ in range(r.traffic["check_steps"])]
    want = reft.steps(P, cfg, r.traffic, feeds, block=r.traffic["reference_block"])
    print("train check: program losses", prog["losses"], "reference", want["losses"], flush=True)
    return compare.train_numbers(prog, want)


def control(r: Run) -> dict:
    """The numbers of the control: the reference with its forward's
    products in fp8 in the program's place, on this seed's first steps."""
    ref.precise()
    cfg, tr = r.cfg, r.traffic
    got = {}
    for name, rounding in (("fp8", ref.control_rounding(cfg)), ("fp32", None)):
        P = {n: t.float() for n, t in W.make(ref.unet_shapes(cfg["unet"]), r.seed, "unet",
                                             r.device, torch.float32).items()}
        feed = feeder(r)
        feeds = [feed() for _ in range(tr["check_steps"])]
        got[name] = reft.steps(P, cfg, tr, feeds, block=tr["reference_block"], rounding=rounding)
        del P
    return compare.train_numbers(got["fp8"], got["fp32"])
