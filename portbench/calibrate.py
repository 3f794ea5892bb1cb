"""The readings a cell's limits are set from, in one process on one card:
the numbers `correct` compares for sound runs of the program on many
seeds; for the control (the reference with every product's operands in
fp8 e4m3, in the program's place: drivers' control()) on a few; for the
program's own int8 FFN weights (weight-only int8) on a few; and for a
train cell the fault of half the batch left out (the reference on half
of each step's rows put in the program's place).

    python3 portbench/calibrate.py --workload <cell> --seconds 4 \
        --seeds 1 2 3 ... --control-seeds 101 102 103 [--int8-seeds 301 302 303] \
        [--fault-seeds 201 202 203] [--out calib.json]

Each run is a short window at the cell's own load; the limits file is
not read (every number is reported).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch_fault(run) -> dict:
    """compare.train_numbers of the reference on the first half of each
    step's rows (the mean over those) against the reference on all."""
    import torch

    from portbench import compare
    from portbench import weights as W
    from portbench.drivers.train import feeder
    from portbench.reference import train as reft
    from portbench.reference import unet as ref

    ref.precise()
    cfg, tr = run.cfg, run.traffic
    feed = feeder(run)
    feeds = [feed() for _ in range(tr["check_steps"])]
    half = [(x[: len(x) // 2], t[: len(t) // 2], e[: len(e) // 2], p, k)
            for x, t, e, p, k in feeds]
    got = {}
    for name, rows in (("full", feeds), ("half", half)):
        P = {n: v.float() for n, v in W.make(ref.unet_shapes(cfg["unet"]), run.seed, "unet",
                                             run.device, torch.float32).items()}
        got[name] = reft.steps(P, cfg, tr, rows, block=tr["reference_block"])
        del P
        gc.collect()
        torch.cuda.empty_cache()
    return compare.train_numbers(got["half"], got["full"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--int8-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    cell, cfg, traffic, limits = harness.find(bench, args.workload)
    dev = torch.device("cuda", 0)
    records = []
    plan = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, "int8") for s in args.int8_seeds] + [(s, "half_batch") for s in args.fault_seeds])
    for seed, kind in plan:
        run = harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits={}, seed=seed,
                          seconds=args.seconds, trace=False, device=dev,
                          started=time.time(), int8=kind == "int8")
        t = time.time()
        if kind == "half_batch":
            numbers, metrics = half_batch_fault(run), {}
        elif kind == "control":
            numbers, metrics = harness.driver(traffic["kind"]).control(run), {}
        else:
            out = harness.driver(traffic["kind"]).run(run)
            numbers, metrics = out.counters["numbers"], out.metrics
        rec = dict(seed=seed, kind=kind, numbers=numbers, metrics=metrics,
                   seconds=time.time() - t)
        records.append(rec)
        print("calib", json.dumps(rec), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for kind in ("program", "control", "int8", "half_batch"):
        rows = [r["numbers"] for r in records if r["kind"] == kind]
        if rows:
            summary[kind] = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                             for k in rows[0]}
    print("summary", json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload, card=torch.cuda.get_device_name(dev),
                           records=records, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
