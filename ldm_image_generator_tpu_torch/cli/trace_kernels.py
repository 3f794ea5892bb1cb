"""Where one kernel call's device time goes, on the card: a torch.profiler
trace of one call (bf16, or --dtype float32) of each kernel wrapper at
each of its path shapes, listing the device kernels of the call's launch
chain with their times. A redesign of a kernel starts from this trace.

    python -m ldm_image_generator_tpu_torch.cli.trace_kernels \
        [--kernels ffn_block_bwd ffn_block ...] [--dtype float32] \
        [--latent 64] [--out FILE]

The shapes are those of `kernels.workloads`: the batch-1 and batch-4
sampling paths (tags b1, b4; block_core_int8 and ffn_block_int8, with
int8 FFN weights, at theirs), the backward kernels of the B=1 train step
(tag train_b1), the B=8 train step (tag train) and the VAE train step
(tag vae_train), on 32x32 latents (256px) or with --latent 64 on the
512px paths' (tags b1-64, ...); every kernel by default. Each call is warmed
up once, then traced once (the L2 holds what the warm-up left there).
Prints, per call, one line per device kernel (name, device us, launches)
and the call's total device time; with --out, the same as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.kernels import vq as tvq
from ldm_image_generator_tpu_torch.kernels import window_attention as tattn
from ldm_image_generator_tpu_torch.kernels.workloads import (
    make_inputs,
    path_calls,
    train_calls,
    vae_train_calls,
)

# wrapper of each kernel, called on make_inputs(call) (+ heads for MHA);
# int8 FFN weights run with grad mode off
KERNELS = {
    "block_core": tbc.block_core,
    "ffn_block": tffn.ffn_block,
    "block_core_int8": lambda *a: torch.no_grad()(tbc.block_core)(*a),
    "ffn_block_int8": lambda *a: torch.no_grad()(tffn.ffn_block)(*a),
    "ffn_block_bwd": tffn.ffn_block_bwd,
    "window_mha": lambda *a: tattn.window_mha(*a[:-1], num_heads=a[-1]),
    "window_mha_bwd": lambda *a: tattn.window_mha_bwd(*a[:-1], num_heads=a[-1]),
    "vq": tvq.nearest_codebook_indices,
}


def calls_of(names, latent: int = 32) -> list:
    """(tag, call) for every path shape of the named kernels."""
    sfx = "" if latent == 32 else f"-{latent}"
    # the B=1 train step's backward kernels (block_core's body backward
    # runs on ffn_block_bwd)
    bwd_b1 = [dataclasses.replace(c, kernel="ffn_block_bwd" if c.kernel == "block_core"
                                  else c.kernel + "_bwd") for c in path_calls(1, latent=latent)]
    tagged = ([("b1" + sfx, c) for c in path_calls(1, latent=latent)]
              + [("b4" + sfx, c) for c in path_calls(4, latent=latent)]
              + [(f"b{b}" + sfx, c) for b in (1, 4) for c in
                 path_calls(b, latent=latent, int8=True) if c.kernel.endswith("_int8")]
              + [("train_b1" + sfx, c) for c in bwd_b1]
              + [("train" + sfx, c) for c in train_calls(8, latent=latent)]
              + [("vae_train", c) for c in vae_train_calls()])
    return [(t, c) for t, c in tagged if c.kernel in names]


def trace_call(fn, args) -> list:
    """[(device us, launches, kernel name)] of one call of fn(*args)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if us > 0:
            rows.append((us, ev.count, ev.key))
    return sorted(rows, reverse=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=sorted(KERNELS),
                    choices=sorted(KERNELS))
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--latent", type=int, default=32, choices=[32, 64])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        print("trace_kernels: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    records = []
    for tag, call in calls_of(args.kernels, args.latent):
        inputs = make_inputs(call, dtype, dev, gen)
        if call.kernel.startswith("window_mha"):
            inputs += (call.heads,)
        rows = trace_call(KERNELS[call.kernel], inputs)
        total = sum(r[0] for r in rows)
        print(f"{call.kernel} {tag} {call.label}: {total:.1f} us device, "
              f"{sum(r[1] for r in rows)} launches", flush=True)
        for us, count, name in rows:
            print(f"    {us:9.1f} us {count:3d}x {name[:100]}", flush=True)
        records.append(dict(kernel=call.kernel, tag=tag, shape=call.label,
                            device_us=total,
                            chain=[dict(us=us, launches=n, name=name[:200])
                                   for us, n, name in rows]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=torch.cuda.get_device_name(0), dtype=args.dtype,
                           calls=records), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
