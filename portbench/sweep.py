"""The knee of a serving cell: its traffic at each of several fixed
rates, one short window each, in one process on one card. Prints per
rate the latency percentiles, the images served per second and whether
the backlog grew (the last quarter's requests waited more than twice as
long as the first quarter's). The cell's rate is set once, from this
sweep, at about 0.8 of the highest rate whose backlog did not grow.

    python3 portbench/sweep.py --workload <cell> --rates 12 14 16 18 20 \
        --seconds 20 [--seed 1] [--out sweep.json]
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    cell, cfg, traffic, _ = harness.find(bench, args.workload)
    dev = torch.device("cuda", 0)
    rows = []
    for rate in args.rates:
        tr = dict(traffic, rate_per_s=rate, check_requests=0)
        run = harness.Run(cell=cell, cfg=cfg, traffic=tr, limits={}, seed=args.seed,
                          seconds=args.seconds, trace=False, device=dev, started=time.time())
        out = harness.driver(tr["kind"]).run(run)
        lat = [v for v in out.counters["latency_ms"] if v is not None]
        q = max(1, len(out.counters["latency_ms"]) // 4)
        first = [v for v in out.counters["latency_ms"][:q] if v is not None]
        last = [v for v in out.counters["latency_ms"][-q:] if v is not None]
        disp = out.counters["dispatches"]
        row = dict(rate=rate, attempted=out.attempted, failed=out.failed,
                   p50_ms=float(np.percentile(lat, 50)), p95_ms=float(np.percentile(lat, 95)),
                   p99_ms=float(np.percentile(lat, 99)),
                   first_quarter_ms=statistics.mean(first), last_quarter_ms=statistics.mean(last),
                   grew=statistics.mean(last) > 2 * statistics.mean(first),
                   mean_batch=sum(r for _, r in disp) / len(disp),
                   late_s=out.counters["late_s"])
        rows.append(row)
        print("sweep", json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(workload=args.workload, card=torch.cuda.get_device_name(dev),
                           seconds=args.seconds, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
