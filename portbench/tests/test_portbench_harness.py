"""The harness on the CPU: discovery by name, the open loop's timing from
due times, the last line's schema, the chip check, and the import check
by whole top-level module names."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, schedule
from portbench.trace import Trace

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_cells_find_their_files():
    bench = harness.load_benchmark()
    for cell in bench["workloads"]:
        found, cfg, traffic, limits = harness.find(bench, cell["name"])
        assert harness.driver(traffic["kind"]).run
        assert limits
    for m in bench["per_layer"]:
        read, rest = harness.reader(m["name"])
        assert callable(read)


def test_a_new_config_mix_and_metric_are_files_and_entries_only(tmp_path):
    # a copy of the benchmark gains a cell, a configuration, a mix and a
    # per-layer metric by new files and BENCHMARK.json entries alone
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_benchmark()
    shutil.copy(HERE / "configs" / "ldm385m-512.json", root / "portbench/configs/ldm-new.json")
    (root / "portbench/traffic/burst.json").write_text(json.dumps({
        "kind": "serve", "phases": [{"seconds": 2, "rate_per_s": 20}, {"seconds": 3, "rate_per_s": 2}],
        "buckets": [1, 2, 4, 8], "max_wait_ms": 25, "max_queue": 1024, "check_requests": 8}))
    (root / "portbench/limits/new-cell.json").write_text('{"img_mean_abs": 1.0}')
    (root / "portbench/metrics/queue_depth.py").write_text(
        "def read(run, out, rest):\n    return 42.0 if rest == ['serve'] else None\n")
    bench["configs"].append({"name": "ldm-new", "source": "https://example.org/x",
                             "file": "portbench/configs/ldm-new.json", "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "new-cell", "config": "ldm-new", "traffic": "burst",
                               "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "queue_depth.serve", "unit": "requests",
                               "better": "lower", "source": "program_counter",
                               "layer": "serving", "moves": "serve_p95_ms",
                               "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    got = harness.load_benchmark(root)
    cell, cfg, traffic, limits = harness.find(got, "new-cell", root)
    assert cfg["name"] == "ldm385m-512" and traffic["phases"][0]["rate_per_s"] == 20
    assert harness.driver(traffic["kind"]).__name__ == "portbench.drivers.serve"
    arr = schedule.arrivals(traffic, 3, 10.0)
    assert len(arr) == 2 * (2 * 20 + 3 * 2)
    read, rest = harness.reader("queue_depth.serve", root / "portbench/metrics")
    assert read(None, None, rest) == 42.0
    out = harness.Outcome(metrics={}, attempted=0, failed=0, checks=[], memory_peak_bytes=0)
    assert harness.per_layer(got, "new-cell", None, out, root) == {
        "queue_depth.serve": {"value": 42.0, "unit": "requests"}}


def test_roofline_reader_takes_the_kernel_from_the_name():
    read, rest = harness.reader("roofline_pct.ffn_block_bwd.train")
    assert rest == ["ffn_block_bwd", "train"]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, 2 ** 40 + 1])
def test_every_seed_offers_the_same_gaps_in_another_order(seed):
    traffic = {"rate_per_s": 16.0}
    a = schedule.arrivals(traffic, seed, 30.0)
    b = schedule.arrivals(traffic, 12345, 30.0)
    gaps = lambda arr: np.sort(np.diff([0.0] + [r["due"] for r in arr]))
    assert len(a) == len(b) == 480
    np.testing.assert_allclose(gaps(a), gaps(b), rtol=1e-9, atol=1e-12)
    assert all(x["due"] <= y["due"] for x, y in zip(a, a[1:]))
    assert a[-1]["due"] == pytest.approx(30.0)
    assert min(r["seed"] for r in a) >= 1


def test_open_loop_times_requests_from_when_they_were_due(monkeypatch):
    # every request is due at once and each dispatch takes 0.2 s: a request
    # served in the k-th dispatch waited for the k - 1 before it, and its
    # latency counts that wait from its due time, not from its submit
    from portbench.drivers import serve

    class FakeServer:
        def __init__(self, variants, traffic, device):
            self.fn = variants[32]
            self.stats = type("S", (), {"snapshot": lambda s: dict.fromkeys(
                ("requests", "batches", "images", "padded_images", "shed", "expired"), 0)})()

        def warmup(self):
            pass

        def start(self):
            from concurrent.futures import ThreadPoolExecutor
            self.pool = ThreadPoolExecutor(1)

        def submit(self, seed, variant=None, guidance=None):
            return self.pool.submit(lambda: (time.sleep(0.2), self.fn([seed], 1))[1][0])

        def stop(self):
            self.pool.shutdown()

    monkeypatch.setattr(serve.program, "pipeline", lambda *a, **k: (None, torch.nn.Linear(1, 1)))
    monkeypatch.setattr(serve.program, "serve_variants",
                        lambda pipe, size, n: {32: lambda seeds, b: np.zeros((b, 2, 2, 3))})
    monkeypatch.setattr(serve.program, "sampler_server", FakeServer)
    monkeypatch.setattr(serve, "check", lambda r, reqs, images: {})
    traffic = {"phases": [{"seconds": 0.01, "rate_per_s": 500.0}], "check_requests": 0}
    cfg = {"image_size": 32, "num_steps": 20}
    run = harness.Run(cell={}, cfg=cfg, traffic=traffic, limits={}, seed=1, seconds=0.01,
                      trace=False, device=torch.device("cpu"), started=time.time())
    out = serve.run(run)
    lat = sorted(out.counters["latency_ms"])
    assert len(lat) == 5 and out.failed == 0
    for k, ms in enumerate(lat):
        assert ms >= 200 * (k + 1) - 20
    assert out.metrics["serve_p95_ms"] >= 900


def test_result_line_schema():
    out = harness.Outcome(metrics={"setup_s": 3.5}, attempted=10, failed=1,
                          checks=[("img_mean_abs", 0.5, 2.0)], memory_peak_bytes=123)
    line = harness.result(out, {"setup_s": {"value": 3.5, "unit": "s"}},
                          {"platform": "gpu", "kind": "X", "count": 1, "memory_peak_bytes": 123},
                          {"device_ops": [["k", 0.1]], "idle_gaps": [["outside spans", 0.2]]})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True and line["checks"] == {
        "img_mean_abs": {"value": 0.5, "limit": 2.0}}
    json.loads(json.dumps(line))
    bad = harness.Outcome(metrics={}, attempted=1, failed=0, checks=[("x", 3.0, 2.0)],
                          memory_peak_bytes=0)
    assert bad.correct is False
    empty = harness.Outcome(metrics={}, attempted=0, failed=0, checks=[], memory_peak_bytes=0)
    assert empty.correct is False


def test_no_card_means_no_result(monkeypatch, capsys):
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ldm512-serve-poisson", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["ldm_image_generator_tpu_torch", "ldm_image_generator_tpu_torch.models.unet",
            "jaxtyping", "flaxen", "ldm_image_generator_tpu.models", "jax.numpy", "jaxlib",
            "flax"]
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib",
                                               "ldm_image_generator_tpu.models"]


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_program_load_no_jax():
    code = ("import sys, json, pathlib; sys.path.insert(0, '.');"
            "from portbench import harness, program, run, calibrate, sweep, work, trace;"
            "from portbench.drivers import serve, train, sample;"
            "import ldm_image_generator_tpu_torch.cli.serve, ldm_image_generator_tpu_torch.serving;"
            "import ldm_image_generator_tpu_torch.pipelines, ldm_image_generator_tpu_torch.train.steps;"
            "[harness.reader(m['name']) for m in harness.load_benchmark()['per_layer']];"
            "print(json.dumps(harness.forbidden_modules(list(sys.modules))))")
    assert _loaded_after(code) == []


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from portbench.reference import unet, sample, train;"
            "from portbench import work, weights, compare;"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ldm_image_generator_tpu_torch', 'ldm_image_generator_tpu', 'jax', 'flax'))))")
    assert _loaded_after(code) == []


def test_trace_reduction_from_markers():
    # host launched: begin window, begin dispatch, end dispatch, end window
    marks = [("begin", "window", {}), ("begin", "dispatch", {"bucket": 8}),
             ("end", "dispatch", {"bucket": 8}), ("end", "window", {})]
    m = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [(0, 10, m), (100, 10, m), (120, 30, "gemm"), (200, 50, "gemm"),
              (300, 10, m), (400, 20, "copy"), (500, 10, m), (600, 5, "after")]
    tr = Trace.from_events(events, marks)
    assert tr.window == (10, 500)
    assert [(n, a, b) for n, _, a, b in tr.spans] == [("dispatch", 110, 300)]
    assert [e[2] for e in tr.ops] == ["gemm", "gemm", "copy"]
    assert tr.busy_s() == pytest.approx(100e-9)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gemm", pytest.approx(80e-9)]
    assert dict(map(tuple, bd["idle_gaps"])) == {
        "dispatch": pytest.approx(110e-9), "outside spans": pytest.approx(280e-9)}
