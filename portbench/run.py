"""Run one cell of the benchmark of ldm_image_generator_tpu_torch (the
PyTorch/CUDA port) on the machine's first CUDA card, and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port. BENCHMARK.json names the
cells; harness.py says where each cell's files are. --trace 0 prints the
cell's end-to-end metrics, --trace 1 its per-layer metrics, read from a
device trace of the window and the run's counters. Every run checks what
its timed path produced against the plain reference (portbench/reference)
and prints each compared number beside its limit, as the last lines of
standard error and under `checks` in the result. Exits non-zero, with no
result, when there is no CUDA card, when the port cannot be imported, and
when jax, jaxlib, flax or the JAX package is loaded once the window has
closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # libraries that would load JAX by themselves, and every build or kernel
    # cache at a fixed path inside the checkout
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    started = harness.process_start()
    bench = harness.load_benchmark()
    cell, cfg, traffic, limits = harness.find(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run: cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), device=dev,
                      started=started)
    harness.phase(run, "torch imported, card found")
    out = harness.driver(traffic["kind"]).run(run)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"run: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"], "memory_peak_bytes": int(out.memory_peak_bytes)}
    breakdown = None
    if args.trace:
        metrics = harness.per_layer(bench, args.workload, run, out)
        device.update(busy_s=out.trace.busy_s(), window_s=out.trace.window_s)
        breakdown = out.trace.breakdown()
    else:
        metrics = harness.end_to_end(bench, args.workload, out)
    print("numbers " + json.dumps(out.counters.get("numbers", {})), file=sys.stderr)
    for name, v, lim in out.checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    if not out.checks:
        print("check: nothing finished to compare", file=sys.stderr)
    print(json.dumps(harness.result(out, metrics, device, breakdown)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
