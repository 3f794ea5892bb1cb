"""Sampling speed of this checkout against another, on one card.

    python -m ldm_image_generator_tpu_torch.cli.sample_ab OTHER_TREE \
        [--rounds 3] [--reps 20] [--cli-defaults] [--out FILE]

OTHER_TREE is a second checkout of the repo (for example the parent
commit, unpacked with `git archive` into a directory .gitignore lists).
Each round starts two worker processes per tree, in the order other,
this, this, other in even rounds and this, other, other, this in odd
ones (so neither tree always runs in the middle); a worker builds its tree's kernels (cached under the tree's
build/), makes the default 256px pipeline with seeded random weights in
bf16, warms up, then times `reps` batch-1 samples and reps // 4 batch-4
samples (20 DDIM steps each; host clock around synchronised calls), and
one more sample of each batch under torch.profiler for the card's busy
time in it; it also records the card's clocks and the host's load. With
--cli-defaults it samples as cli/sample_ldm does at its defaults: fp32,
512px, batch 1 only. The
trees are never loaded into one process, since both hold a package of
the same name. It prints one JSON line per worker and a summary: per
tree and batch the median and min seconds per sample, images/s and the
card's busy seconds per sample, and per round this tree's median over
the other's.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[2]

# run with cwd = a tree, argv = [batch-1 reps, dtype, image side, batches
# (comma-separated)]; uses only the API that every slice of the port has
# (LDMPipeline.random/sample, _build.build_all)
WORKER = r"""
import json, os, subprocess, sys, time
import torch
from torch.profiler import ProfilerActivity, profile
from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

reps, dtype, size = int(sys.argv[1]), getattr(torch, sys.argv[2]), int(sys.argv[3])
batches = [int(b) for b in sys.argv[4].split(",")]
_build.build_all()
pipe = LDMPipeline.random(dtype=dtype, device="cuda", seed=0)
gen = torch.Generator(device="cuda").manual_seed(0)
out = {}
for batch in batches:
    n = reps if batch == 1 else max(1, reps // 4)
    for _ in range(2):
        pipe.sample(gen, batch=batch, image_size=size, num_steps=20)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.sample(gen, batch=batch, image_size=size, num_steps=20)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out[f"b{batch}"] = times
    # one more sample under the profiler (which slows the host many
    # times over, so only the card's busy time in it is kept)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.sample(gen, batch=batch, image_size=size, num_steps=20)
        torch.cuda.synchronize()
    out[f"b{batch}_device_busy_s"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if "CUDA" in str(e.device_type)) / 1e6
out["gpu"] = subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
     "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
out["loadavg"] = os.getloadavg()
print(json.dumps(out))
"""


def run_worker(tree: Path, reps: int, setting=("bfloat16", 256, "1,4")) -> dict:
    res = subprocess.run([sys.executable, "-c", WORKER, str(reps), *map(str, setting)],
                         cwd=tree, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"worker in {tree} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def summarize(runs: list) -> dict:
    """runs: [(round, tree label, {"b1": [s...], "b4": [s...], ...})]. Per
    batch: each tree's median and min over all its samples and the median
    of its workers' device busy time per sample, and per round
    the ratio of this tree's median to the other's (both of the round's
    workers pooled), so that a slow spell of the host, which moves whole
    workers, lands on both trees of one round."""
    out = {}
    rounds = sorted({rnd for rnd, _, _ in runs})
    for key, batch in (("b1", 1), ("b4", 4)):
        if key not in runs[0][2]:
            continue
        per = {}
        for label in ("this", "other"):
            times = [t for _, lab, r in runs if lab == label for t in r[key]]
            med = statistics.median(times)
            busy = [r[f"{key}_device_busy_s"] for _, lab, r in runs
                    if lab == label and f"{key}_device_busy_s" in r]
            per[label] = dict(median_s=med, min_s=min(times),
                              images_per_s=batch / med, samples=len(times),
                              device_busy_s=statistics.median(busy) if busy else None)
        ratios = []
        for rnd in rounds:
            med = {lab: statistics.median([t for r0, l0, r in runs
                                           if r0 == rnd and l0 == lab
                                           for t in r[key]])
                   for lab in ("this", "other")}
            ratios.append(med["this"] / med["other"])
        per["round_ratios"] = ratios
        per["median_round_ratio"] = statistics.median(ratios)
        per["this_lower_in_rounds"] = f"{sum(r < 1 for r in ratios)}/{len(ratios)}"
        per["this_over_other_median"] = (per["this"]["median_s"]
                                         / per["other"]["median_s"])
        out[key] = per
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20,
                    help="batch-1 samples per worker (batch 4: reps // 4)")
    ap.add_argument("--cli-defaults", action="store_true",
                    help="sample as cli/sample_ldm at its defaults: fp32, 512px, batch 1")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every worker's times here (JSON)")
    args = ap.parse_args(argv)
    setting = ("float32", 512, "1") if args.cli_defaults else ("bfloat16", 256, "1,4")
    trees = {"this": THIS_TREE, "other": args.other.resolve()}
    runs = []
    for rnd in range(args.rounds):
        order = ("other", "this") if rnd % 2 == 0 else ("this", "other")
        for label in order + order[::-1]:
            r = run_worker(trees[label], args.reps, setting)
            runs.append((rnd, label, r))
            print(json.dumps({"round": rnd, "tree": label, **r}), flush=True)
    summary = summarize(runs)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"runs": runs, "summary": summary}))
    return summary


if __name__ == "__main__":
    main()
