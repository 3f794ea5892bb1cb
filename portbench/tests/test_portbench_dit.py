"""The DiT cell's pieces on the CPU: work_dit's FLOP count from the widths
against FlopCounterMode over the reference (tiny and DiT-XL/2 on the meta
device) and its attention count against the reference's attention
alone; the benchmark's reference copy against reference_torch/dit.py;
the attention roofline and MFU readers on synthetic spans; a tiny run of
the cell's driver, sound and with an image altered where the pipeline
makes it."""
from __future__ import annotations

import copy
import dataclasses
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ldm_image_generator_tpu_torch.config import DiTConfig
from ldm_image_generator_tpu_torch.utils import profiling
from ldm_image_generator_tpu_torch.utils.profiling import Span
from portbench import harness, program_spans, work, work_dit
from portbench.harness import Outcome
from portbench.reference import dit as bench_ref
from portbench.trace import Trace
from reference_torch import dit as plain_ref

CELL = "dit512-cfg-b32"
SEED = 2 ** 31 + 43
TINY = dataclasses.asdict(DiTConfig().tiny())


def params(cfg: dict, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(s, generator=g) * (0.02 if fan is None else 0.1)
            for n, (s, fan) in bench_ref.shapes(cfg).items()}


@pytest.mark.parametrize("cfg", [TINY, dataclasses.asdict(DiTConfig.xl_2())],
                         ids=["tiny", "xl_2"])
@pytest.mark.parametrize("batch", [1, 3])
def test_flops_from_the_widths_match_flop_counter(cfg, batch):
    assert work_dit.forward_flops_from_widths(cfg, batch) == work_dit.forward_flops(cfg, batch)


def test_attention_flops_match_flop_counter():
    P = params(TINY)
    x = torch.randn(3, 16, TINY["hidden_size"])
    with FlopCounterMode(display=False) as fc:
        bench_ref.attention(P, "blocks.0.attn", x, TINY["num_heads"])
    d = TINY["hidden_size"]
    projections = 2 * 3 * 16 * (3 * d * d + d * d)
    _, flops = work_dit.attention_call(3, 16, TINY["num_heads"], d // TINY["num_heads"])
    assert fc.get_total_flops() == projections + flops
    _, flops = work_dit.attention_call(32, 1024, 16, 72)
    assert work_dit.attention_bound_s(32, 1024, 16, 72) == flops / work.PEAK_BF16_FLOPS


def test_the_two_reference_copies_agree():
    P = params(TINY)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 8, 4, generator=g)
    y = torch.tensor([3, TINY["num_classes"]])
    t = torch.tensor([400])
    assert torch.equal(bench_ref.forward(P, TINY, x, t, y), plain_ref.forward(P, TINY, x, t, y))
    ab = plain_ref.alpha_bar()
    assert torch.equal(bench_ref.sample(P, TINY, x, y, 1.5, 3, ab),
                       plain_ref.sample(P, TINY, x, y, 1.5, 3, ab))
    assert bench_ref.shapes(TINY) == plain_ref.shapes(TINY)


def synthetic(monkeypatch, kernels_per_call=4, shapes=((2, 16, 4, 16),) * 4):
    """A window [0, 2000) with two sample spans, the second cut; one
    whole pipeline.sample whose dit.attention spans have `shapes`; each
    sample span holding `kernels_per_call` flash kernels of 10 ns."""
    sp, ops = [], []

    def add(name, start, end, parent=None, **attrs):
        s = Span(name, len(sp) + 1, parent and parent.id, 1, start, end, attrs)
        sp.append(s)
        return s

    call = add("pipeline.sample", 10, 900, batch=2, steps=2, guided=True)
    for i, shape in enumerate(shapes):
        unet = add("pipeline.unet", 20 + 200 * i, 200 + 200 * i, call, rows=2)
        add("dit.attention", 30 + 200 * i, 40 + 200 * i, unet,
            **dict(zip(("rows", "tokens", "heads", "head_dim"), shape)))
    for lo in (0, 1000):
        ops += [(lo + 100 + 100 * k, 10, "pytorch_flash::flash_fwd_kernel<...>")
                for k in range(kernels_per_call)]
        ops += [(lo + 150, 40, "gemm")]
    trace = Trace(ops=sorted(ops), window=(0, 2000),
                  spans=[("sample", {"batch": 2}, 0, 950),
                         ("sample", {"batch": 2, "cut": True}, 1000, 2000)])
    monkeypatch.setattr(profiling, "records", lambda: list(sp))
    program_spans._cache[:] = [None, None]
    return Outcome(metrics={}, attempted=1, failed=0, checks=[], memory_peak_bytes=0,
                   counters={"guided": True}, trace=trace)


def read(name, run, out):
    fn, rest = harness.reader(name)
    return fn(run, out, rest)


def test_attention_roofline_reads_the_whole_calls(monkeypatch):
    out = synthetic(monkeypatch)
    want = 100.0 * 4 * work_dit.attention_bound_s(2, 16, 4, 16) / (4 * 10e-9)
    assert read("roofline_pct.dit_attention.dit", None, out) == pytest.approx(want)
    # a kernel more than the program's attention calls: nothing is read
    assert read("roofline_pct.dit_attention.dit", None,
                synthetic(monkeypatch, kernels_per_call=5)) is None


def test_mfu_counts_cut_calls_by_their_share(monkeypatch):
    _, cfg, traffic, _ = harness.find(harness.load_benchmark(), CELL)
    run = harness.Run(cell={}, cfg=cfg, traffic=traffic, limits={}, seed=1, seconds=1.0,
                      trace=True, device=torch.device("cpu"))
    out = synthetic(monkeypatch)
    share = out.trace.done_share("sample", {"batch": 2, "cut": True}, 1000, 2000)
    flops = work_dit.sample_call_flops(cfg, 2, True)
    want = 100.0 * (1 + share) * flops / (out.trace.window_s * work.PEAK_BF16_FLOPS)
    assert read("mfu_pct.dit", run, out) == pytest.approx(want)


def tiny_run(**over) -> harness.Run:
    cell, cfg, traffic, limits = harness.find(harness.load_benchmark(), CELL)
    cfg = copy.deepcopy(cfg)
    cfg["dit"].update(input_size=16, hidden_size=64, depth=2, num_heads=4, num_classes=5)
    cfg["vae"].update(encoder_channels=[16, 32], encoder_stages=[1, 1],
                      decoder_channels=[32, 16], decoder_stages=[1, 1], num_embeddings=64)
    cfg.update(image_size=32, num_steps=4, compute_dtype="float32")
    traffic = dict(traffic, batch=2, **over)
    return harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=SEED,
                       seconds=1.0, trace=False, device=torch.device("cpu"),
                       started=time.time())


def test_sound_run_is_correct():
    out = harness.driver("dit_sample").run(tiny_run())
    assert out.correct, out.checks
    assert out.counters["attention_calls"] == out.attempted * 4 * 2 * 2


def test_an_image_altered_where_it_is_made_is_caught(monkeypatch):
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    sample = LDMPipeline.sample

    def altered(self, *a, **k):
        img, z = sample(self, *a, **k)
        img[0] = 255 - img[0]
        return img, z
    monkeypatch.setattr(LDMPipeline, "sample", altered)
    out = harness.driver("dit_sample").run(tiny_run(check_calls=40))
    assert not out.correct, out.checks


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    from portbench import compare

    cell, cfg, traffic, limits = harness.find(harness.load_benchmark(), CELL)
    r = harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=SEED,
                    seconds=30.0, trace=False, device=torch.device("cuda", 0),
                    started=time.time())
    checks = compare.limited(harness.driver(traffic["kind"]).control(r), limits)
    assert checks and any(v > lim for _, v, lim in checks), checks
