"""What every run shares: finding a cell's configuration, traffic mix,
limits and per-layer readers by name, the run's record, and the result
line.

Layout, all found by the names in BENCHMARK.json:
  configs/<file>            a configuration, as BENCHMARK.json's `file`
  traffic/<traffic>.json    a traffic mix: `kind` names the module
                            (drivers/<kind>.py) that generates and runs it
  limits/<cell>.json        the limit of each number `correct` compares
  metrics/<name>.py         a per-layer metric's reader, found by the
                            longest dotted prefix of the metric's name;
                            read(run, rest) gets the remaining parts
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ldm_image_generator_tpu")


@dataclasses.dataclass
class Run:
    """One run of one cell: what drivers/<kind>.py gets."""

    cell: dict
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    int8: bool = False          # the program's int8 FFN weights (the control)
    started: float = 0.0        # process start, epoch seconds


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""

    metrics: Dict[str, float]          # end-to-end, by name (host clock)
    attempted: int
    failed: int
    checks: List[tuple]                # (name, value, limit)
    memory_peak_bytes: int
    counters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Any = None                  # trace.Trace of the traced window

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration dict, traffic dict, limits dict) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    here = root / HERE.name
    with open(here / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(here / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    return cell, cfg, traffic, limits


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(name: str, metrics_dir: Path = HERE / "metrics"):
    """(read function, remaining name parts) for a per-layer metric: the
    module metrics/<longest dotted prefix of name>.py."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = metrics_dir / (".".join(parts[:k]) + ".py")
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{k}_{parts[0]}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read, parts[k:]
    raise FileNotFoundError(f"no reader for metric {name!r} under {metrics_dir}")


def per_layer(bench: dict, workload: str, run: Run, out: Outcome,
              root: Path = ROOT) -> Dict[str, dict]:
    """{name: {value, unit}} of the cell's per-layer metrics that found
    something to read (a reader returns None otherwise)."""
    got = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        read, rest = reader(m["name"], root / HERE.name / "metrics")
        v = read(run, out, rest)
        if v is not None:
            got[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return got


def end_to_end(bench: dict, workload: str, out: Outcome) -> Dict[str, dict]:
    got = {}
    for m in bench["end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        if m["name"] in out.metrics:
            got[m["name"]] = {"value": float(out.metrics[m["name"]]), "unit": m["unit"]}
    return got


def phase(run: "Run", what: str) -> None:
    """One line on standard error: seconds since the process started."""
    print(f"phase {what}: {time.time() - run.started:.2f} s", file=sys.stderr, flush=True)


def process_start() -> float:
    """Epoch seconds at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def checks_line(checks) -> Dict[str, dict]:
    return {name: {"value": float(v), "limit": float(lim)} for name, v, lim in checks}


def result(out: Outcome, metrics: dict, device: dict, breakdown: Optional[dict]) -> dict:
    """The last line's object; `checks` (each compared number beside its
    limit) comes last."""
    line = {"correct": out.correct, "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks_line(out.checks)
    return line
