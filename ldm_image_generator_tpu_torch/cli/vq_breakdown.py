"""Where one vq call's device time goes, on the card: csrc/vq.cu built
once per VQ_DROP setting (parts of its main loop taken out), each build
timed at the VAE train step's shape (4608 latents, K = 8192), x in fp32
and bf16, with the L2 flushed before each call (cold) and back to back
(warm); then the floor under any call: the kernel at one row and eight
codes, and one PyTorch add of one element.

    python -m ldm_image_generator_tpu_torch.cli.vq_breakdown [--reps 20]

The builds go to build/vq_breakdown/ beside the port's own libraries. A
build with VQ_DROP set returns wrong indices: it is timed, never used.
Prints the card's name and power limit, then one line per (type, build)
in the order full, no compare, no products, neither, staging only; the
rounds alternate the builds' order.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.kernels.workloads import make_inputs, vae_train_calls

# VQ_DROP of each build (csrc/vq.cu): bit 0 no products, bit 1 no
# compare, bit 2 no main loop
BUILDS = {"full": 0, "no compare": 2, "no products": 1, "neither": 3, "staging only": 4}
SLEEP_CYCLES = 20_000_000  # as chip_smoke.py: the host enqueues ahead of the card


def _build_all(out_dir) -> dict:
    """{build name: loaded library}, one nvcc each, all started at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, drop in BUILDS.items():
        so = out_dir / f"vq_drop{drop}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-DVQ_DROP={drop}", "-o", str(so),
               str(_build.CSRC / "vq.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    argtypes, restype = _build._SIGNATURES["vq"]["vq_nearest"]
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for VQ_DROP={BUILDS[name]}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.vq_nearest.argtypes, lib.vq_nearest.restype = argtypes, restype
        libs[name] = lib
    return libs


def _cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _warm_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vq_breakdown needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    libs = _build_all(_build.BUILD_DIR.parent / "vq_breakdown")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    stream = _build.current_stream()

    def call_of(lib, x, cb, out):
        code, n, k = _build.dtype_code(x), x.shape[0], cb.shape[0]

        def fn():
            _build.check(lib, lib.vq_nearest(code, x.data_ptr(), cb.data_ptr(), n, k,
                                              out.data_ptr(), stream), "vq")
        return fn

    (call,) = vae_train_calls()
    for dtype in (torch.float32, torch.bfloat16):
        x, cb = make_inputs(call, dtype, dev, gen)
        out = torch.empty((call.n,), dtype=torch.int32, device=dev)
        for rnd in range(args.rounds):
            names = list(BUILDS) if rnd % 2 == 0 else list(reversed(BUILDS))
            for name in names:
                fn = call_of(libs[name], x, cb, out)
                print(f"round {rnd} {str(dtype)[6:]} [{call.n},{call.c}] K={call.l} {name}: "
                      f"cold {_cold_ms(fn, args.reps, flush):.5f} ms, "
                      f"warm {_warm_ms(fn, 5 * args.reps):.5f} ms", flush=True)
    x1, cb1 = x[:1].contiguous(), cb[:8].contiguous()
    out1 = torch.empty((1,), dtype=torch.int32, device=dev)
    fn = call_of(libs["full"], x1, cb1, out1)
    print(f"floor [1,8] K=8 full: cold {_cold_ms(fn, args.reps, flush):.5f} ms, "
          f"warm {_warm_ms(fn, 5 * args.reps):.5f} ms", flush=True)
    one = torch.zeros((1,), device=dev)
    fn = lambda: one.add_(1.0)  # noqa: E731
    print(f"floor torch add_ of one element: cold {_cold_ms(fn, args.reps, flush):.5f} ms, "
          f"warm {_warm_ms(fn, 5 * args.reps):.5f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
