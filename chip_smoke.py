"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py             # the whole check, as below
    python3 chip_smoke.py --profile   # plus a torch.profiler pass (B=1)

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):
  1. build the CUDA kernels from kernels/csrc (one nvcc per source, in
     parallel); print the build seconds and the card's name and power limit;
  2. hold each kernel against its plain PyTorch version at every call
     shape of the sampling path (batch 1 and 4, plus block_core at latent
     64), in fp32 with TF32 off and in bf16; time kernel, plain version
     and (window MHA) the one-call PyTorch equivalent with a cold L2;
  3. sample one 256px image with the default UNet and VAE decoder (seeded
     random weights, 20 DDIM steps, bf16): launch counts must be exactly
     720 block_core and 160 window MHA; then images/s;
  4. sample 4 images in one call: 720 ffn_block launches, 0 block_core;
  5. one full-width denoise step in fp32 on the card against the same
     weights on the CPU (plain versions).
The last line is {"ok": true, "device": {...}}; the line before it is
the kernels' JSON record.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import torch

# the card must finish a whole run within this many seconds
TIME_LIMIT_S = 1200
# bf16 kernel vs plain: both round at the same points, so a differing
# fp32 summation order moves a value by at most about one bf16 ulp at a
# rounding point (2**-8 relative), which the later products carry on
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# full-width fp32 step, card vs CPU: 36 blocks of fp32 sums in other
# orders; the error is held against the output's scale
STEP_REL_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def require(ok, what) -> None:
    """Fail the run (and so the phase) when a check does not hold."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# GPU clock cycles the card spins before each timed call, so the host
# has enqueued the whole call (checks, allocations, every launch of a
# kernel chain or plain version) before the card reaches it: the events
# then time device work, not the host's enqueue (~10 ms at H100 clocks)
SLEEP_CYCLES = 20_000_000


def cold_ms(fn, args, reps: int, flush: torch.Tensor) -> float:
    """Mean device ms of fn(*args), L2 flushed before each call."""
    fn(*args)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_kernels(dev, reps: int) -> dict:
    """Check and time every kernel at the path's call shapes."""
    import torch.nn.functional as F

    from ldm_image_generator_tpu_torch.kernels import block_core as tbc
    from ldm_image_generator_tpu_torch.kernels.block_core import grouped_conv3x3
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.kernels import window_attention as tattn
    from ldm_image_generator_tpu_torch.kernels.workloads import (
        bound_ms,
        make_inputs,
        path_calls,
    )

    def mha_library(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, heads):
        """One PyTorch call computing window MHA (yardstick only)."""
        c = x.shape[-1]
        xt = x.transpose(0, 1)
        return F.multi_head_attention_forward(
            xt, xt, xt, c, heads, None, torch.cat([bq, bk, bv]), None, None,
            False, 0.0, wo.t(), bo, training=False, key_padding_mask=mask,
            need_weights=False, use_separate_proj_weight=True,
            q_proj_weight=wq.t(), k_proj_weight=wk.t(),
            v_proj_weight=wv.t())[0]

    fns = {
        "block_core": (tbc.block_core, tbc.block_core_plain, None),
        "ffn_block": (tffn.ffn_block, tffn.ffn_block_plain, None),
        "window_mha": (lambda *a: tattn.window_mha(*a[:-1], num_heads=a[-1]),
                       lambda *a: tattn.window_mha_plain(*a[:-1], num_heads=a[-1]),
                       mha_library),
    }
    sources = {
        "block_core": ("ldm_image_generator_tpu_torch/kernels/csrc/block_core.cu",
                       "ldm_image_generator_tpu/kernels/block_core.py:453"),
        "ffn_block": ("ldm_image_generator_tpu_torch/kernels/csrc/ffn_block.cu",
                      "ldm_image_generator_tpu/kernels/ffn_block.py:221"),
        "window_mha": ("ldm_image_generator_tpu_torch/kernels/csrc/window_attention.cu",
                       "ldm_image_generator_tpu/kernels/window_attention.py:188"),
    }
    b1, b4 = path_calls(1), path_calls(4)
    # the B=1 body shapes through ffn_block and the B=4 ones through
    # block_core, so the batch split can be re-decided on this card
    swap = lambda c, k: type(c)(k, c.batch, c.hw, c.c, c.per_step)
    cross = [swap(c, "ffn_block") for c in b1 if c.kernel == "block_core"] + [
        swap(c, "block_core") for c in b4 if c.kernel == "ffn_block"]
    latent64 = [c for c in path_calls(1, latent=64) if c.kernel == "block_core"]
    calls = [(c, "b1") for c in b1] + [(c, "b4") for c in b4] + [
        (c, "b1-64") for c in latent64] + [(c, "split") for c in cross]
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for call, tag in calls:
        kernel, plain, library = fns[call.kernel]
        extra = (call.heads,) if call.kernel == "window_mha" else ()
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            args = make_inputs(call, dtype, dev, gen) + extra
            got, want = kernel(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = 0.0  # max |kernel - plain| over the outputs, this dtype
            for g, w in zip(got, want):
                require(torch.isfinite(g.float()).all(), (call, dtype))
                torch.testing.assert_close(g.float(), w.float(), **tol)
                err = max(err, (g.float() - w.float()).abs().max().item())
            if dtype == torch.float32:
                err_fp32 = err
                continue
            ms = cold_ms(kernel, args, reps, flush)
            plain_ms = cold_ms(plain, args, reps, flush)
            lib_ms = None if library is None else cold_ms(library, args, reps, flush)
            bms, by = bound_ms(call, dtype)
            row = dict(kernel=call.kernel, tag=tag, shape=call.label,
                       per_step=call.per_step, max_abs_err=err,
                       max_abs_err_fp32=err_fp32, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                       bound_by=by)
            if call.kernel == "ffn_block":
                # the grouped conv ffn_block leaves outside (plain
                # PyTorch, as the SwinBlock runs it), for the batch split
                c = call.c
                h4 = args[0].reshape(call.batch, call.hw, call.hw, c)
                ck, cb = make_inputs(type(call)("block_core", 1, 1, c, 1),
                                     dtype, dev, gen)[-3:-1]
                row["conv_ms"] = cold_ms(grouped_conv3x3, (h4, ck, cb), reps,
                                         flush)
            rows.append(row)
            log("kernel", json.dumps(row))
    summary = {}
    for name in fns:
        main = [r for r in rows if r["kernel"] == name
                and r["tag"] == ("b4" if name == "ffn_block" else "b1")]
        per_step = lambda key: sum(r[key] * r["per_step"] for r in main)
        libs = [r["library_ms"] for r in main]
        bound = per_step("bound_ms")
        ops_bound = sum(r["bound_ms"] * r["per_step"] for r in main
                        if r["bound_by"] == "operations")
        summary[name] = dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=None,
            max_abs_err=max(r["max_abs_err"] for r in main),
            ms=per_step("ms"), kernel_ms=per_step("ms"),
            plain_ms=per_step("plain_ms"), bound_ms=bound,
            bound_by="operations" if ops_bound > bound / 2 else "bytes",
            library_ms=None if None in libs else per_step("library_ms"),
            per="one denoise step of the main path: sum over its call "
                "shapes of calls x cold-L2 ms per call, bf16")
    return summary


def run_path(pipe, batch: int, generator):
    from ldm_image_generator_tpu_torch.kernels import block_core as tbc
    from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
    from ldm_image_generator_tpu_torch.kernels import window_attention as tattn

    tbc.launches = tffn.launches = tattn.launches = 0
    img, z = pipe.sample(generator, batch=batch, image_size=256, num_steps=20,
                         return_latent=True)
    torch.cuda.synchronize()
    counts = dict(block_core=tbc.launches, ffn_block=tffn.launches,
                  window_mha=tattn.launches)
    require(img.dtype == torch.uint8
            and tuple(img.shape) == (batch, 256, 256, 3), img.shape)
    require(tuple(z.shape) == (batch, 32, 32, 8) and torch.isfinite(z).all(),
            "final latent finite and [B, 32, 32, 8]")
    return counts


def phase_path(dev, profile: bool) -> dict:
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    t0 = time.perf_counter()
    pipe = LDMPipeline.random(dtype=torch.bfloat16, device=dev, seed=0)
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    log(f"path: default UNet {n_params} params, built in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    pipe.sample(gen, batch=1, image_size=256, num_steps=20)  # warm-up
    counts = run_path(pipe, 1, gen)
    log("path b1 launches", json.dumps(counts))
    require(counts == dict(block_core=720, ffn_block=0, window_mha=160), counts)
    out = {"launches_b1": counts}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.sample(gen, batch=1, image_size=256, num_steps=20)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["b1_sample_s"] = times
    out["b1_images_per_s"] = 1.0 / (sum(times) / len(times))
    log("path b1 sample seconds", times, "images/s", out["b1_images_per_s"])
    if profile:
        out["profile_b1"] = profile_sample(pipe, gen)

    counts = run_path(pipe, 4, gen)
    log("path b4 launches", json.dumps(counts))
    require(counts == dict(block_core=0, ffn_block=720, window_mha=160), counts)
    out["launches_b4"] = counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.sample(gen, batch=4, image_size=256, num_steps=20)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["b4_sample_s"] = dt
    out["b4_images_per_s"] = 4.0 / dt
    log("path b4 sample seconds", dt, "images/s", out["b4_images_per_s"])
    return out


def profile_sample(pipe, gen) -> dict:
    """Device time by kernel name over one B=1 sample (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.sample(gen, batch=1, image_size=256, num_steps=20)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device kernels only: CPU ops also carry their kernels' time
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us > 0 and "CUDA" in str(getattr(ev, "device_type", "")):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    for ms, count, key in rows[:25]:
        log(f"profile {ms:10.3f} ms {count:6d}x {key[:90]}")
    log(f"profile: wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                top=[dict(ms=r[0], count=r[1], name=r[2][:90]) for r in rows[:25]])


def phase_card_vs_cpu(dev) -> float:
    """One full-width fp32 denoise step, card kernels vs CPU plain versions."""
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.models.unet import UNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = UNet(UNetConfig(), device="cpu",
               generator=torch.Generator().manual_seed(1)).eval()
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((1, 32, 32, 8), generator=gen)
    t = torch.tensor([526], dtype=torch.int32)
    plan = torch.randint(0, 6, (cpu.plan_length(),), generator=gen)
    with torch.no_grad():
        ref = cpu(x, t, moe_plan=plan)
        got = card(x.to(dev), t.to(dev), moe_plan=plan.to(dev)).cpu()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    log(f"card vs cpu fp32 step: max abs err {err:.3e}, output max {scale:.3e}")
    require(torch.isfinite(got).all(), "card step output finite")
    require(err <= STEP_REL_TOL * scale, (err, scale))
    return err / scale


def main(argv) -> int:
    t_start = time.perf_counter()
    profile = "--profile" in argv
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; nothing to check")
        return 1
    from ldm_image_generator_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    name = card_line()
    log(name)
    build_s = _build.build_all()
    log(f"build: {build_s:.2f} s for {len(_build.SOURCES)} sources")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = phase_kernels(dev, reps=10)
    log(f"kernels checked at {time.perf_counter() - t_start:.1f} s")
    path = phase_path(dev, profile)
    kernels["block_core"]["launches"] = path["launches_b1"]["block_core"]
    kernels["window_mha"]["launches"] = path["launches_b1"]["window_mha"]
    kernels["ffn_block"]["launches"] = path["launches_b4"]["ffn_block"]
    rel = phase_card_vs_cpu(dev)
    elapsed = time.perf_counter() - t_start
    require(elapsed < TIME_LIMIT_S, elapsed)
    log(json.dumps({"summary": {
        "card": name, "build_s": build_s, "elapsed_s": elapsed,
        "b1_images_per_s": path["b1_images_per_s"],
        "b4_images_per_s": path["b4_images_per_s"],
        "card_vs_cpu_rel_err": rel}}))
    log(name)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
