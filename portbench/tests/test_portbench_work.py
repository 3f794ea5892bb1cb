"""The yardstick's arithmetic against hand counts (CPU)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import work
from portbench.reference import unet as ref

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_ffn_block_by_hand():
    # B=8 at the 64x64 level of a 512px latent: 32768 rows of C = M = 128,
    # one timestep for the batch (a 64x64 FiLM pair)
    rows, c, m = 8 * 64 * 64, 128, 128
    nbytes, flops = work.ffn_block(rows, c, m, 64 * 64)
    # three ReGLU towers, each x@wa, x@wb (C x M) and g@wc (M x C)
    assert flops == 3 * 3 * 2 * rows * c * m == 9_663_676_416
    weights = 3 * (c * m + c * m + m * c + m + m + c)
    assert nbytes == 2 * (rows * c + 2 * 64 * 64 * c + 2 * rows * c) + 2 * weights + 8
    assert nbytes == 27_560_200
    # bound by operations: 9.66 GFLOP at 989 TFLOP/s over 27.6 MB at 3.35 TB/s
    assert work.call_bound_s("ffn_block", {"ffn_mul": 1}, c, 64, 8, 1) == pytest.approx(
        9_663_676_416 / 989e12)


def test_ffn_block_bwd_by_hand():
    # B=32 at the 8x8 level: 2048 rows of C = M = 1024
    rows, c, m = 32 * 8 * 8, 1024, 1024
    nbytes, flops = work.ffn_block_bwd(rows, c, m)
    # per tower: recompute a, b (2 products), dg = g wc^T, dwc = gate^T g,
    # da and db to dh (2), dwa and dwb (2): 8 products of rows x C x M
    assert flops == 3 * 8 * 2 * rows * c * m == 103_079_215_104
    tower = 3 * (3 * c * m + 2 * m)
    # h, g in and dh out in bf16; weights in bf16, their gradients in fp32
    assert nbytes == 2 * 3 * rows * c + 2 * tower + 4 * tower + 8 == 69_242_888
    assert work.call_bound_s("ffn_block_bwd", {"ffn_mul": 1}, c, 8, 32, 32) == pytest.approx(
        103_079_215_104 / 989e12)


def test_frozen_copy_reads_as_the_ports_bf16_work():
    from ldm_image_generator_tpu_torch.kernels.workloads import Call, work as port_work

    for kernel, frozen in (("ffn_block", lambda: work.ffn_block(4 * 32 * 32, 256, 256, 32 * 32)),
                           ("ffn_block_bwd", lambda: work.ffn_block_bwd(4 * 32 * 32, 256, 256))):
        nbytes, ops = port_work(Call(kernel, 4, 32, 256, 1), torch.bfloat16)
        assert (nbytes, ops[torch.bfloat16]) == frozen()


def test_model_count_by_hand():
    # one block's MoE as the reference computes it: the general tower and
    # the two routed experts, 18 rows C M
    c, rows = 64, 2 * 8 * 8
    shapes = {k: s for k, (s, _) in ref.unet_shapes(
        {**json.load(open(CONFIGS / "ldm385m-512.json"))["unet"],
         "stages": [1], "channels": [c]}).items() if ".ffn." in k}
    P = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    h = torch.empty((2, 8, 8, c), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.moe(P, "enc_stage_0.block_0", h, (1, 3))
    assert fc.get_total_flops() == 18 * rows * c * c


def test_forward_count_is_affine_in_the_batch():
    with open(CONFIGS / "ldm385m-512.json") as f:
        cfg = json.load(f)
    ucfg = dict(cfg["unet"], stages=[1, 1], channels=[32, 64])
    counted = {}
    for b in (1, 2, 3):
        with FlopCounterMode(display=False) as fc:
            P = {n: torch.empty(s, device="meta") for n, (s, _) in ref.unet_shapes(ucfg).items()}
            ref.unet(P, ucfg, torch.empty((b, 16, 16, 8), device="meta"),
                     torch.zeros((1,), dtype=torch.int64, device="meta"), [0, 0, 0, 0])
        counted[b] = fc.get_total_flops()
    assert work.unet_forward_flops(ucfg, 3, 16, False) == counted[3]
