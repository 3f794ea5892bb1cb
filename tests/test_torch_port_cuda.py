"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere. This file imports
neither JAX nor the JAX package, so on a machine without JAX run it
without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_port_cuda.py
"""
import dataclasses

import pytest
import torch

from ldm_image_generator_tpu_torch.kernels import _build
from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.kernels import vq as tvq
from ldm_image_generator_tpu_torch.kernels import window_attention as tattn
from ldm_image_generator_tpu_torch.kernels.workloads import (
    BWD_REL,
    VQ_TIE_REL,
    Call,
    GuardedBuffers,
    bwd_scale_err,
    cond_body_calls,
    dequantized_bwd_inputs,
    ffn_bwd_boundary_plain,
    make_inputs,
    near_tie_codebook,
    path_calls,
    tie_codebook,
    train_calls,
    vae_train_calls,
    vq_mismatches,
)

torch.set_num_threads(1)

WRAPPERS = {
    "block_core": (tbc, tbc.block_core, tbc.block_core_plain),
    "ffn_block": (tffn, tffn.ffn_block, tffn.ffn_block_plain),
    # int8 FFN weights: the same wrappers, counted in int8_launches
    "block_core_int8": (tbc, tbc.block_core, tbc.block_core_plain),
    "ffn_block_int8": (tffn, tffn.ffn_block, tffn.ffn_block_plain),
    "window_mha": (tattn, lambda *a: tattn.window_mha(*a[:-1], num_heads=a[-1]),
                   lambda *a: tattn.window_mha_plain(*a[:-1], num_heads=a[-1])),
}
BWD_WRAPPERS = {
    "ffn_block_bwd": (tffn, tffn.ffn_block_bwd, tffn.ffn_block_bwd_plain),
    "window_mha_bwd": (
        tattn, lambda *a: tattn.window_mha_bwd(*a[:-1], num_heads=a[-1]),
        lambda *a: tattn.window_mha_bwd_plain(*a[:-1], num_heads=a[-1])),
}
# fp32 (TF32 off): summation order only. bf16: both versions round at the
# same points, so a differing sum order can move a value by one bf16 ulp
# (2**-8 relative) at a rounding point
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# window MHA tiling edges: rows (n L) 108 and 16, neither a multiple of
# 64 (108 not of 16); C=64 with 2 heads; masked and unmasked; C=1024 with
# 32 heads at L=16 comes from path_calls. Then shapes the bf16
# tensor-core route does not take, which run the FMA route in both
# types: head dim 64, L=80, head dim 16 (C=16, one head).
MHA_EDGES = [
    Call("window_mha", 1, 0, 64, 1, n=3, l=36, heads=2, masked=True),
    Call("window_mha", 1, 0, 64, 1, n=3, l=36, heads=2),
    Call("window_mha", 1, 0, 64, 1, n=1, l=16, heads=2),
    Call("window_mha", 1, 0, 1024, 1, n=3, l=36, heads=32, masked=True),
]
MHA_FMA_ONLY = [
    Call("window_mha", 1, 0, 128, 1, n=2, l=36, heads=2, masked=True),
    Call("window_mha", 1, 0, 64, 1, n=2, l=80, heads=2),
    Call("window_mha", 1, 0, 16, 1, n=3, l=36, heads=1, masked=True),
]
MHA_EDGES += MHA_FMA_ONLY
# ffn_block (and its backward) at every path shape: the batch-1 rows (the
# body split across the batch; the tensor-core route splits k there), batch
# 4 and the B=8 train step; then ragged row counts (40, 100) and C = M =
# 48, which bfloat16 runs on the FMA route
FFN_FMA_ONLY = [Call("ffn_block", 1, 4, 48, 1)]
FFN_SHAPES = [dataclasses.replace(c, kernel="ffn_block")
              for c in path_calls(1) + path_calls(4) + path_calls(8)
              if c.kernel in ("block_core", "ffn_block")] + [
    Call("ffn_block", 10, 2, 128, 1), Call("ffn_block", 1, 10, 128, 1),
] + FFN_FMA_ONLY
# int8 FFN weights: block_core at the B=1 path shapes (latent 32 and 64)
# and an odd map; ffn_block at every FFN shape above (B=4 is the path's;
# the B=1 rows split k, so splits span the output kernel's towers)
INT8_CALLS = [dataclasses.replace(c, kernel="block_core_int8")
              for c in path_calls(1) + path_calls(1, latent=64) + [Call("block_core", 2, 5, 64, 1)]
              if c.kernel == "block_core"] + [
    dataclasses.replace(c, kernel="ffn_block_int8") for c in FFN_SHAPES]
CALLS = [c for c in path_calls(1) + path_calls(4)] + [
    Call("block_core", 2, 5, 64, 1),        # odd map, C below 128, 2 images
] + MHA_EDGES
CALLS += [c for c in FFN_SHAPES if c not in CALLS] + INT8_CALLS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_kernel_matches_plain(card, call, dtype):
    """Each wrapper's kernel against its plain version; an int8 call
    (grad mode off) launches the int8 chain, never the full-precision one."""
    mod, kernel, plain = WRAPPERS[call.kernel]
    gen = torch.Generator(device=card).manual_seed(0)
    args = make_inputs(call, dtype, card, gen)
    if call.kernel == "window_mha":
        args = args + (call.heads,)
    int8 = call.kernel.endswith("_int8")
    counts = lambda: (mod.launches, getattr(mod, "int8_launches", 0))
    before = counts()
    with torch.set_grad_enabled(not int8):
        got = kernel(*args)
    assert counts() == (before[0] + (not int8), before[1] + int8)
    want = plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


# backward kernels, each output against the plain version's at
# workloads.BWD_REL (which says why)
BWD_CALLS = [c for c in train_calls(8) if c.kernel.endswith("_bwd")] + [
    Call("ffn_block_bwd", 1, 5, 64, 1),     # ragged N, C below 128
] + [dataclasses.replace(c, kernel="window_mha_bwd")
     for c in MHA_EDGES + [Call("window_mha", 1, 0, 1024, 1, n=1, l=16, heads=32)]]
BWD_CALLS += [c for c in (dataclasses.replace(f, kernel="ffn_block_bwd") for f in FFN_SHAPES)
              if c not in BWD_CALLS]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", BWD_CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_backward_kernel_matches_plain(card, call, dtype):
    """Each output within BWD_REL of its scale; an ffn_block_bwd ReLU
    decision the kernel and the plain version took apart within the fp32
    sum's bound of 0 is taken from the kernel (workloads.
    ffn_bwd_boundary_plain), and none may lie outside that bound."""
    mod, kernel, plain = BWD_WRAPPERS[call.kernel]
    gen = torch.Generator(device=card).manual_seed(3)
    args = make_inputs(call, dtype, card, gen)
    if call.kernel == "window_mha_bwd":
        args = args + (call.heads,)
    before = mod.bwd_launches
    got = kernel(*args)
    assert mod.bwd_launches == before + 1
    want = plain(*args)
    torch.cuda.synchronize()
    if call.kernel == "ffn_block_bwd" and any(
            bwd_scale_err(g, w) > BWD_REL[dtype] for g, w in zip(got, want)):
        want, differ, away, _ = ffn_bwd_boundary_plain(kernel, plain, args)
        print(call.label, dtype, differ, "ReLU decisions taken apart,", away, "away")
        assert away == 0
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.isfinite(g).all(), i
        rel = bwd_scale_err(g, w)
        print(call.kernel, call.label, dtype, i, rel)
        assert rel <= BWD_REL[dtype], (i, rel)


# the 512px paths (latent 64): window MHA at B=1, 4 and 8 (C=1024 on an
# 8x8 map now runs windowed, padded and shifted with a key mask, where
# latent 32's 4x4 map attends whole), ffn_block at B=4 (16,384 rows at
# C=128), and the backward kernels of the B=8 train step and of the B=1
# one (the block_core route's body backward runs on ffn_block_bwd)
_B64 = {b: path_calls(b, latent=64) for b in (1, 4, 8)}
LATENT64_CALLS = list(dict.fromkeys(
    [c for b in (1, 4, 8) for c in _B64[b] if c.kernel == "window_mha"]
    + [c for c in _B64[4] if c.kernel == "ffn_block"]
    + [dataclasses.replace(c, kernel="ffn_block_bwd" if c.kernel == "block_core"
                           else c.kernel + "_bwd") for b in (1, 8) for c in _B64[b]]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", LATENT64_CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_latent64_kernels_match_plain_rerun_bitwise_inside_their_buffers(
        card, monkeypatch, call, dtype):
    """Each kernel at a latent-64 shape: launched (its count up by one),
    every buffer its wrapper allocates between sentinel guards (no guard
    written, the split counters left 0), two reruns bitwise equal, and the
    result against the plain version (forward at TOL; backward at
    BWD_REL, an ffn_block_bwd ReLU decision the two took apart within the
    fp32 sum's bound of 0 taken from the kernel, as workloads says)."""
    bwd = call.kernel.endswith("_bwd")
    mod, kernel, plain = (BWD_WRAPPERS if bwd else WRAPPERS)[call.kernel]
    gen = torch.Generator(device=card).manual_seed(64)
    args = make_inputs(call, dtype, card, gen)
    if call.kernel.startswith("window_mha"):
        args = args + (call.heads,)
    count = "bwd_launches" if bwd else "launches"
    before = getattr(mod, count)
    monkeypatch.setattr(mod, "_counters", {})
    with GuardedBuffers() as guarded:
        got = kernel(*args)
        torch.cuda.synchronize()
    monkeypatch.undo()
    assert getattr(mod, count) == before + 1
    assert guarded.made and guarded.faults() == []
    got = got if isinstance(got, tuple) else (got,)
    for _ in range(2):
        again = kernel(*args)
        again = again if isinstance(again, tuple) else (again,)
        for i, (a, b) in enumerate(zip(got, again)):
            assert torch.equal(a, b), i
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    if call.kernel == "ffn_block_bwd" and any(
            bwd_scale_err(g, w) > BWD_REL[dtype] for g, w in zip(got, want)):
        want, differ, away, _ = ffn_bwd_boundary_plain(kernel, plain, args)
        print(call.label, dtype, differ, "ReLU decisions taken apart,", away, "away")
        assert away == 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all(), i
        if bwd:
            assert bwd_scale_err(g, w) <= BWD_REL[dtype], i
        else:
            torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


# every window MHA shape: the sampling paths (batch 1 and 4; clusters of
# 3 CTAs and split output projections), the B=8 train step (split weight
# gradients and dx) and the edges above
MHA_SHAPES = [c for c in path_calls(1) + path_calls(4) + path_calls(8)
              if c.kernel == "window_mha"] + MHA_EDGES


def _mha_call(direction, call, dtype, device, gen):
    """Inputs of the window MHA forward or backward at call, and the
    function that runs it on them."""
    if direction == "backward":
        call = dataclasses.replace(call, kernel="window_mha_bwd")
        return make_inputs(call, dtype, device, gen), lambda *a: tattn.window_mha_bwd(
            *a, num_heads=call.heads)
    return make_inputs(call, dtype, device, gen), lambda *a: tattn.window_mha(
        *a, num_heads=call.heads)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("call", MHA_SHAPES, ids=lambda c: c.label)
def test_window_mha_reruns_bitwise_equal(card, call, direction):
    """bf16 window MHA three times on the same inputs: every output has
    the same bits, the fp32 weight gradients (rows split over blocks,
    summed in a fixed order by the last block of each tile) included."""
    gen = torch.Generator(device=card).manual_seed(8)
    args, fn = _mha_call(direction, call, torch.bfloat16, card, gen)
    first = fn(*args)
    first = first if isinstance(first, tuple) else (first,)
    for _ in range(2):
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        for i, (a, b) in enumerate(zip(first, again)):
            assert torch.equal(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("call", MHA_SHAPES, ids=lambda c: c.label)
def test_window_mha_writes_only_inside_its_buffers(card, monkeypatch, call, direction,
                                                  dtype):
    """Every buffer the wrapper allocates (outputs, intermediates, split
    partials, split counters) lies between guards of a sentinel: after the
    call (launch checked, device synchronised) no guard has changed, the
    split counters are back to 0 and the result equals the plain
    version's."""
    gen = torch.Generator(device=card).manual_seed(10)
    args, fn = _mha_call(direction, call, dtype, card, gen)
    monkeypatch.setattr(tattn, "_counters", {})
    with GuardedBuffers() as guarded:
        got = fn(*args)
        torch.cuda.synchronize()
    monkeypatch.undo()
    assert guarded.made and guarded.faults() == []
    plain = tattn.window_mha_bwd_plain if direction == "backward" else tattn.window_mha_plain
    want = plain(*args, num_heads=call.heads)
    if direction == "backward":
        for i, (g, w) in enumerate(zip(got, want)):
            assert bwd_scale_err(g, w) <= BWD_REL[dtype], i
    else:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_window_mha_route_depends_on_shape_alone(card):
    """Both directions run the tensor-core route at every window MHA shape
    of the UNet (head dim 32, L <= 64, latent 32 and 64) in bf16 and in
    fp32 (three TF32 passes), the FMA route elsewhere."""
    lib = _build.load("window_attention")
    unet = [c for latent in (32, 64) for b in (1, 4, 8) for c in path_calls(b, latent=latent)
            if c.kernel == "window_mha"]
    for c in unet + MHA_EDGES:
        tc = c not in MHA_FMA_ONLY
        for code in (0, 1):
            assert lib.window_mha_tensor_cores(code, c.l, c.c, c.heads) == tc, c.label
            assert lib.window_mha_bwd_tensor_cores(code, c.l, c.c, c.heads) == tc, c.label
    # the fp32 launch chains: the two TF32 kernels each way, no FMA kernel
    gen = torch.Generator(device=card).manual_seed(25)
    call = path_calls(1)[1]
    args = make_inputs(call, torch.float32, card, gen)
    with torch.no_grad():
        chain = _device_kernels(lambda: tattn.window_mha(*args, num_heads=call.heads))
    assert sum(chain.values()) == 2, chain
    assert all(any(name in k for k in chain)
               for name in ("wtf::fwd_core_kernel", "wtf::out_proj_kernel")), chain
    bcall = dataclasses.replace(call, kernel="window_mha_bwd")
    bargs = make_inputs(bcall, torch.float32, card, gen)
    chain = _device_kernels(lambda: tattn.window_mha_bwd(*bargs, num_heads=call.heads))
    assert sum(chain.values()) == 2, chain
    assert all(any(name in k for k in chain)
               for name in ("wtf::bwd_core_kernel", "wtf::bwd_tail_kernel")), chain


def _ffn_call(direction, call, dtype, device, gen):
    """Inputs of ffn_block or its backward at call, the wrapper and its
    plain version."""
    if direction == "backward":
        call = dataclasses.replace(call, kernel="ffn_block_bwd")
        return (make_inputs(call, dtype, device, gen), tffn.ffn_block_bwd,
                tffn.ffn_block_bwd_plain)
    return make_inputs(call, dtype, device, gen), tffn.ffn_block, tffn.ffn_block_plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("call", FFN_SHAPES, ids=lambda c: c.label)
def test_ffn_reruns_bitwise_equal(card, call, direction, dtype):
    """ffn_block and its backward three times on the same inputs: every
    output has the same bits, the split-k gate and output tiles and the
    row-split fp32 weight gradients (summed in a fixed order) included."""
    gen = torch.Generator(device=card).manual_seed(11)
    args, fn, _ = _ffn_call(direction, call, dtype, card, gen)
    first = fn(*args)
    for _ in range(2):
        for i, (a, b) in enumerate(zip(first, fn(*args))):
            assert torch.equal(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("call", FFN_SHAPES, ids=lambda c: c.label)
def test_ffn_writes_only_inside_its_buffers(card, monkeypatch, call, direction, dtype):
    """Every buffer the wrapper allocates (outputs, h, the gate, da/db,
    split partials, split counters) lies between guards of a sentinel:
    after the call no guard has changed, the split counters are back to 0
    and the result equals the plain version's (a backward ReLU decision
    the two took apart within the fp32 sum's bound of 0 taken from the
    kernel, as workloads.ffn_bwd_boundary_plain says)."""
    gen = torch.Generator(device=card).manual_seed(12)
    args, fn, plain = _ffn_call(direction, call, dtype, card, gen)
    monkeypatch.setattr(tffn, "_counters", {})
    with GuardedBuffers() as guarded:
        got = fn(*args)
        torch.cuda.synchronize()
    monkeypatch.undo()
    assert guarded.made and guarded.faults() == []
    want = plain(*args)
    if direction == "backward" and any(
            bwd_scale_err(g, w) > BWD_REL[dtype] for g, w in zip(got, want)):
        want, differ, away, _ = ffn_bwd_boundary_plain(fn, plain, args)
        print(call.label, dtype, differ, "ReLU decisions taken apart,", away, "away")
        assert away == 0
    for i, (g, w) in enumerate(zip(got, want)):
        if direction == "backward":
            assert bwd_scale_err(g, w) <= BWD_REL[dtype], i
        else:
            torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


@pytest.mark.cuda
def test_ffn_route_depends_on_shape_alone(card):
    """bf16 and fp32 run the tensor-core route at every FFN shape of the
    UNet (C and M multiples of 64, C <= 1024) and the FMA route elsewhere,
    both directions (fp32 as TF32 passes); an fp32 forward's launch chain
    is norm/FiLM and the two TF32 kernels, with fp32 and with int8 weights
    (none of the FMA chain's), a backward's the two TF32 kernels."""
    fwd, bwd = _build.load("ffn_block"), _build.load("ffn_block_bwd")
    for c in FFN_SHAPES + [Call("ffn_block", 1, 64, 128, 1), Call("ffn_block", 8, 64, 128, 1)]:
        n, tc = c.batch * c.hw * c.hw, c not in FFN_FMA_ONLY
        for code in (0, 1):
            assert fwd.ffn_tensor_cores(code, n, c.c, c.c) == tc, c.label
            assert bwd.ffn_bwd_tensor_cores(code, n, c.c, c.c) == tc, c.label
    for route in (fwd.ffn_tensor_cores, bwd.ffn_bwd_tensor_cores):
        for code in (0, 1):
            assert route(code, 64, 128, 96) == 0  # M not a multiple of 64
            assert route(code, 64, 1088, 1088) == 0  # C above 1024
    gen = torch.Generator(device=card).manual_seed(26)
    for kernel in ("ffn_block", "ffn_block_int8"):
        args = make_inputs(Call(kernel, 4, 16, 256, 1), torch.float32, card, gen)
        with torch.no_grad():
            chain = _device_kernels(lambda: tffn.ffn_block(*args))
        assert sum(chain.values()) == 3, (kernel, chain)
        assert all(any(name in k for k in chain) for name in (
            "norm_film_rows_kernel<float>", "ftc::gate_kernel<float",
            "ftc::out_kernel<float")), (kernel, chain)
        assert not any("finish_kernel" in k or "partial" in k for k in chain), (kernel, chain)
    args = make_inputs(Call("ffn_block_bwd", 1, 16, 256, 1), torch.float32, card, gen)
    chain = _device_kernels(lambda: tffn.ffn_block_bwd(*args))
    assert sum(chain.values()) == 2, chain
    assert all(any(name in k for k in chain)
               for name in ("gate_grad_kernel_f32", "tail_kernel_f32")), chain


# ffn_block's bf16 wgmma route (csrc/ffn_wg_fwd.cuh) at the benchmark's
# call shapes: served bucket 32 at C=128 (131,072 rows) and C=1024 (2,048),
# bucket 4 at C=1024 (256 rows, below the route's rule: mma.sync with split
# k), the B=256 CFG call at C=128 (262,144 rows) and C=512 (16,384); the
# B=8 train forward at latent 64, C=256 (8,192 rows); a ragged row count
# (1,875, not a multiple of 128)
WGMMA_CALLS = [Call("ffn_block", 32, 64, 128, 1), Call("ffn_block", 32, 8, 1024, 1),
               Call("ffn_block", 4, 8, 1024, 1), Call("ffn_block", 256, 32, 128, 1),
               Call("ffn_block", 256, 8, 512, 1), Call("ffn_block", 8, 32, 256, 1),
               Call("ffn_block", 3, 25, 512, 1)]


def _wgmma_takes(n: int, c: int) -> bool:
    """The route's rule as the test reads it: bf16 weights, C = M a
    multiple of 128, and the gate's tiles (128 rows by 128 hidden columns,
    three towers) fill the card's SMs once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return c % 128 == 0 and 3 * -(-n // 128) * (c // 128) >= sms


@pytest.mark.cuda
@pytest.mark.parametrize("ids", [None, (2, 0), (3, 3)], ids=["ids13", "ids20", "ids33"])
@pytest.mark.parametrize("call", WGMMA_CALLS, ids=lambda c: c.label)
def test_ffn_wgmma_route_matches_plain_and_reruns_bitwise(card, call, ids):
    """bf16 ffn_block at the route's shapes against its plain version (the
    routed experts (1, 3) as make_inputs gives them, (2, 0) and (3, 3)),
    two calls bitwise equal, launches counting both calls and
    wgmma_launches exactly those the rule sends to the route."""
    lib = _build.load("ffn_block")
    n = call.batch * call.hw * call.hw
    takes = _wgmma_takes(n, call.c)
    assert lib.ffn_wgmma_route(1, 0, n, call.c, call.c) == takes
    gen = torch.Generator(device=card).manual_seed(31)
    args = list(make_inputs(call, torch.bfloat16, card, gen))
    if ids is not None:
        args[-1] = torch.tensor(ids, dtype=torch.int32, device=card)
    before = (tffn.launches, tffn.wgmma_launches)
    with torch.no_grad():
        got = tffn.ffn_block(*args)
        again = tffn.ffn_block(*args)
    assert (tffn.launches, tffn.wgmma_launches) == (before[0] + 2, before[1] + 2 * takes)
    want = tffn.ffn_block_plain(*args)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_ffn_wgmma_route_rule_and_launch_chain(card):
    """The route takes every ffn_block call of the CFG cell (B=256, latent
    32) and of served buckets 16 and 32 (latent 64), and bf16 calls only:
    never int8 weights, float32 or C, M not multiples of 128; a call on it
    launches norm/FiLM, the wgmma gate and output kernels and nothing else,
    the output kernel's name ending as the benchmark's roofline reader
    closes a call."""
    lib = _build.load("ffn_block")
    channels, stages = (128, 256, 512, 1024), range(4)
    for batch, side in ((256, 32), (32, 64), (16, 64), (8, 64), (4, 64)):
        for i, c in zip(stages, channels):
            n = batch * (side >> i) ** 2
            takes = lib.ffn_wgmma_route(1, 0, n, c, c)
            assert takes == _wgmma_takes(n, c), (batch, c)
            if batch >= 16:
                assert takes, (batch, c)
            assert lib.ffn_wgmma_route(1, 1, n, c, c) == 0  # int8 weights
            assert lib.ffn_wgmma_route(0, 0, n, c, c) == 0  # float32
    assert lib.ffn_wgmma_route(1, 0, 1 << 16, 192, 192) == 0
    assert lib.ffn_wgmma_route(1, 0, 1 << 16, 128, 192) == 0
    gen = torch.Generator(device=card).manual_seed(27)
    args = make_inputs(Call("ffn_block", 32, 16, 512, 1), torch.bfloat16, card, gen)
    with torch.no_grad():
        chain = _device_kernels(lambda: tffn.ffn_block(*args))
    assert sum(chain.values()) == 3, chain
    assert any("norm_film_rows_kernel<__nv_bfloat16>" in k for k in chain), chain
    assert any("ftc::gate_kernel<ldm::ftc::WgGate" in k for k in chain), chain
    assert any("ftc::out_kernel<ldm::ftc::WgOut" in k
               and k.endswith("false>(ldm::ftc::FwdArgs)") for k in chain), chain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", [c for c in FFN_SHAPES if c.batch == 8] + FFN_FMA_ONLY,
                         ids=lambda c: c.label)
def test_ffn_block_bwd_equal_expert_ids(card, call, dtype):
    """Both routed slots on expert 2: each output holds against the plain
    version, and the two slots' gradients are bitwise equal. In fp32 an
    output may leave 1e-4 only where a ReLU pre-activation b lies within
    the two sides' summation error of 0 (the FMA kernel and cuBLAS sum in
    other orders, so [b > 0] may differ and move one row's contribution:
    workloads.BWD_REL); it must then stay within the bf16 bound."""
    gen = torch.Generator(device=card).manual_seed(13)
    args = list(make_inputs(dataclasses.replace(call, kernel="ffn_block_bwd"), dtype,
                            card, gen))
    args[-1] = torch.tensor((2, 2), dtype=torch.int32, device=card)
    got = tffn.ffn_block_bwd(*args)
    want = tffn.ffn_block_bwd_plain(*args)
    torch.cuda.synchronize()
    h, _, _, _, gwb, gbb, _, _, _, wb, bb, _, _ = args
    b_min = min((h.double() @ w.double() + c.double()).abs().min().item()
                for w, c in ((gwb, gbb), (wb[2], bb[2])))
    for i, (g, w) in enumerate(zip(got, want)):
        err = bwd_scale_err(g, w)
        if dtype == torch.float32 and err > BWD_REL[dtype]:
            assert b_min < 1e-5 and err <= BWD_REL[torch.bfloat16], (i, err, b_min)
        else:
            assert err <= BWD_REL[dtype], (i, err)
    for k in range(5):
        assert torch.equal(got[6 + k], got[11 + k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", INT8_CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_int8_reruns_bitwise_and_writes_only_inside_its_buffers(card, monkeypatch, call,
                                                                dtype):
    """An int8 call with every buffer the wrapper allocates (outputs, h,
    the gate, split partials, split counters) between guards of a
    sentinel: no guard changed, the split counters back to 0; then two
    reruns with the same bits, and the plain version's result."""
    mod, fn, plain = WRAPPERS[call.kernel]
    gen = torch.Generator(device=card).manual_seed(15)
    args = make_inputs(call, dtype, card, gen)
    monkeypatch.setattr(tffn, "_counters", {})
    with torch.no_grad():
        with GuardedBuffers() as guarded:
            first = fn(*args)
            torch.cuda.synchronize()
        monkeypatch.undo()
        assert guarded.made and guarded.faults() == []
        for _ in range(2):
            for i, (a, b) in enumerate(zip(first, fn(*args))):
                assert torch.equal(a, b), i
    for g, w in zip(first, plain(*args)):
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_cols_on_the_card_equals_the_cpu(card, dtype):
    """quantize_cols makes the same int8 weights and scale-bias rows on
    the card as on the CPU (stacked C=1024 experts and a C=128 matrix)."""
    gen = torch.Generator().manual_seed(16)
    for shape in ((4, 1024, 1024), (128, 128)):
        w = (torch.randn(shape, generator=gen) / 32).to(dtype)
        b = torch.randn(shape[:-2] + shape[-1:], generator=gen).to(dtype)
        for got, want in zip(tffn.quantize_cols(w.to(card), b.to(card)),
                             tffn.quantize_cols(w, b)):
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_ffn_takes_expert_ids_off_a_16_byte_boundary(card):
    """The UNet passes each block's ids as a row of an [n, 2] int32 plan,
    8 bytes apart: the tensor-core route reads them element by element and
    takes any offset (only activations and weight matrices are read in
    16-byte chunks), with full-precision and int8 weights."""
    gen = torch.Generator(device=card).manual_seed(14)
    plan = torch.tensor([[0, 1], [1, 3]], dtype=torch.int32, device=card)
    assert plan[1].data_ptr() % 16 == 8
    for kernel in ("ffn_block", "ffn_block_bwd", "ffn_block_int8"):
        args = list(make_inputs(Call(kernel, 4, 8, 128, 1), torch.bfloat16, card, gen))
        args[-1] = plan[1]
        fn, plain = ((tffn.ffn_block, tffn.ffn_block_plain) if kernel != "ffn_block_bwd"
                     else (tffn.ffn_block_bwd, tffn.ffn_block_bwd_plain))
        with torch.set_grad_enabled(kernel != "ffn_block_int8"):
            got = fn(*args)
        for i, (g, w) in enumerate(zip(got, plain(*args))):
            if kernel != "ffn_block_bwd":
                torch.testing.assert_close(g.float(), w.float(), **TOL[torch.bfloat16])
            else:
                assert bwd_scale_err(g, w) <= BWD_REL[torch.bfloat16], i


def _grads(fn, leaves, cotangents):
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cotangents)
    return [t.grad for t in leaves if t is not None and t.requires_grad]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ffn_block", "block_core", "window_mha"])
def test_gradients_through_cuda_wrappers_equal_plain_path(card, kernel):
    """Every input gradient the CPU plain path gives, the CUDA path gives
    too, and equal (fp32): the wrappers are autograd Functions whose
    backward launches the backward kernels (here their fp32 tensor-core
    routes)."""
    call = {"ffn_block": Call("ffn_block", 4, 8, 128, 1),
            "block_core": Call("block_core", 1, 8, 128, 1),
            "window_mha": Call("window_mha", 1, 0, 128, 1, n=6, l=36,
                               heads=4, masked=True)}[kernel]
    gen = torch.Generator(device="cpu").manual_seed(4)
    args = make_inputs(call, torch.float32, "cpu", gen)
    fn = {"ffn_block": tffn.ffn_block, "block_core": tbc.block_core,
          "window_mha": lambda *a: tattn.window_mha(*a, num_heads=call.heads)}[kernel]
    diff = lambda a: a is not None and a.dtype == torch.float32
    cpu = [a.clone().requires_grad_(diff(a)) if a is not None else None for a in args]
    dev = [a.detach().to(card).requires_grad_(diff(a)) if a is not None else None
           for a in args]
    n_out = 1 if kernel == "window_mha" else 2
    cot = [torch.randn(args[0].shape, generator=gen) for _ in range(n_out)]
    want = _grads(fn, cpu, cot)
    got = _grads(fn, dev, [c.to(card) for c in cot])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g is not None and w is not None
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_block_core_without_residual_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(1)
    args = make_inputs(Call("block_core", 1, 8, 256, 1), torch.float32, card, gen)
    for g, w in zip(tbc.block_core(*args, add_residual=False),
                    tbc.block_core_plain(*args, add_residual=False)):
        torch.testing.assert_close(g, w, **TOL[torch.float32])


# block_core on the bf16 tensor-core route: the B=1 path shapes at latent
# 32 and 64 (maps 4-64 wide; C=1024 has 16 rows, a ragged tile, and
# splits k over blocks) and an odd map (2 images of 5 x 5, 50 rows, C=64,
# a batch-1 FiLM); C=96 is not a multiple of 64, so bf16 runs the FMA chain
BLOCK_CORE_TC = [c for c in path_calls(1) + path_calls(1, latent=64)
                 if c.kernel == "block_core"] + [Call("block_core", 2, 5, 64, 1)]
BLOCK_CORE_FMA_ONLY = Call("block_core", 1, 4, 96, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("add_residual", [True, False], ids=["residual", "no-residual"])
@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("call", BLOCK_CORE_TC, ids=lambda c: c.label)
def test_block_core_tensor_cores_match_plain_rerun_bitwise_inside_their_buffers(
        card, monkeypatch, call, weights, add_residual):
    """bf16 block_core on the tensor cores, with bf16 and with int8 FFN
    weights: every buffer the wrapper allocates (out, h, the gate, split
    partials, split counters) between guards of a sentinel, none of which
    changes, the counters back to 0; two reruns with the same bits; and
    the plain version's result (the conv taps at the image edges and
    between images read zeros, the conv bias and residual added once)."""
    lib = _build.load("block_core")
    n = call.batch * call.hw * call.hw
    assert lib.block_core_tensor_cores(1, int(weights == "int8"), n, call.c, call.c) == 1
    kernel = "block_core_int8" if weights == "int8" else "block_core"
    gen = torch.Generator(device=card).manual_seed(17)
    args = make_inputs(dataclasses.replace(call, kernel=kernel), torch.bfloat16, card, gen)
    fn = lambda: tbc.block_core(*args, add_residual=add_residual)
    monkeypatch.setattr(tffn, "_counters", {})
    with torch.no_grad():
        with GuardedBuffers() as guarded:
            first = fn()
            torch.cuda.synchronize()
        monkeypatch.undo()
        assert guarded.made and guarded.faults() == []
        for _ in range(2):
            for i, (a, b) in enumerate(zip(first, fn())):
                assert torch.equal(a, b), i
    for g, w in zip(first, tbc.block_core_plain(*args, add_residual=add_residual)):
        torch.testing.assert_close(g.float(), w.float(), **TOL[torch.bfloat16])


# a class-conditioned UNet: every decoder block runs block_core without
# its residual (cond_body_calls: one shape per decoder stage, B=1)
COND_CALLS = cond_body_calls(1) + cond_body_calls(1, int8=True)


@pytest.mark.cuda
@pytest.mark.parametrize("call", COND_CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_block_core_without_residual_at_the_conditioned_decoder_shapes(
        card, monkeypatch, call):
    """bf16 block_core with add_residual=False (the argument make_inputs
    appends), full-precision and int8 FFN weights: every wrapper buffer
    between sentinel guards, two reruns with the same bits, the plain
    version's result, and the launch counted on its weight type's
    counter."""
    assert not call.residual
    gen = torch.Generator(device=card).manual_seed(23)
    args = make_inputs(call, torch.bfloat16, card, gen)
    assert args[-1] is False
    int8 = call.kernel.endswith("_int8")
    monkeypatch.setattr(tffn, "_counters", {})
    before = (tbc.launches, tbc.int8_launches)
    with torch.no_grad():
        with GuardedBuffers() as guarded:
            first = tbc.block_core(*args)
            torch.cuda.synchronize()
        monkeypatch.undo()
        assert guarded.made and guarded.faults() == []
        for _ in range(2):
            for i, (a, b) in enumerate(zip(first, tbc.block_core(*args))):
                assert torch.equal(a, b), i
    assert (tbc.launches - before[0], tbc.int8_launches - before[1]) == (
        (0, 3) if int8 else (3, 0))
    for g, w in zip(first, tbc.block_core_plain(*args)):
        torch.testing.assert_close(g.float(), w.float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_conditional_unet_guided_step_card_vs_cpu(card):
    """One guided fp32 prediction of a class-conditional UNet (two stages
    of 128 and 256 channels, 3 classes; class 1 and the null class under
    one routing plan, guidance 3, rescale 0.7) on the card against the
    CPU's plain versions, within 1e-3 of the output's scale."""
    from ldm_image_generator_tpu_torch.config import UNetConfig
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.pipelines import guide

    cfg = UNetConfig(num_classes=3, stages=(2, 2), channels=(128, 256))
    cpu = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    dev = UNet(cfg, device=card)
    dev.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((1, 16, 16, 8), generator=gen)
    t = torch.tensor([611], dtype=torch.int32)
    plan = cpu.draw_plan(gen)
    outs = []
    for unet, d in ((cpu, "cpu"), (dev, card)):
        run = lambda c: unet(x.to(d), t.to(d), torch.tensor([c], device=d),
                             moe_plan=plan.to(d)).float()
        with torch.no_grad():
            outs.append(guide(run(1), run(3), 3.0, 0.7).cpu())
    ref, got = outs
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


def _device_kernels(fn) -> dict:
    """{device kernel name: launches} of one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if (getattr(ev, "self_device_time_total", 0.0) or 0.0) > 0}


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_block_core_route_depends_on_shape_alone(card, weights):
    """bf16 and fp32 at a tensor-core width, with either weight type, run
    three launches (norm/FiLM, the gate, the output product with the
    conv; in fp32 the TF32 kernels) and no finish_kernel; bf16 and fp32
    at C=96 run the FMA chain with its finish_kernel; each matches the
    plain version."""
    lib = _build.load("block_core")
    gen = torch.Generator(device=card).manual_seed(19)
    suffix = "_int8" if weights == "int8" else ""
    tc_call = Call("block_core" + suffix, 1, 8, 128, 1)
    fma_call = dataclasses.replace(BLOCK_CORE_FMA_ONLY, kernel="block_core" + suffix)
    for call, dtype, tc in ((tc_call, torch.bfloat16, True),
                            (tc_call, torch.float32, True),
                            (fma_call, torch.bfloat16, False),
                            (fma_call, torch.float32, False)):
        n = call.batch * call.hw * call.hw
        assert lib.block_core_tensor_cores(_build.DTYPE_CODES[dtype], int(weights == "int8"),
                                           n, call.c, call.c) == tc
        args = make_inputs(call, dtype, card, gen)
        with torch.no_grad():
            chain = _device_kernels(lambda: tbc.block_core(*args))
            got = tbc.block_core(*args)
        finish = [k for k in chain if "finish_kernel" in k]
        if tc:
            assert sum(chain.values()) == 3 and not finish, chain
            out = "ftc::out_kernel<" + ("float" if dtype == torch.float32 else "")
            assert any(out in k for k in chain), chain
        else:
            assert finish, chain
        for g, w in zip(got, tbc.block_core_plain(*args)):
            torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


# fp32 block_core, ffn_block and window MHA forward on the tensor cores
# (TF32 passes): every call of a B=1 sample at latent 32 and 64,
# block_core at the fp32 train steps' B=2 shapes (a film per image, no
# residual fold: the stochastic-depth gate) and an odd map (2 images of 5
# x 5, C=64); ffn_block at a B=4 sample's calls, latent 32 and 64; with
# int8 FFN weights block_core at B=1 and ffn_block at B=4, latent 32 and
# 64; then both backward kernels (ffn_block_bwd, window MHA's) at every
# call of the fp32 train steps, 256px and 512px (latent 32 and 64), B=1
# (the block_core route's body backward runs on ffn_block_bwd) and B=8
_BWD_OF = lambda c: dataclasses.replace(
    c, kernel="ffn_block_bwd" if c.kernel == "block_core" else c.kernel + "_bwd")
FP32_TC_CALLS = path_calls(1) + path_calls(1, latent=64) + [
    dataclasses.replace(c, residual=False, film_batch=2)
    for c in path_calls(2) if c.kernel == "block_core"] + [Call("block_core", 2, 5, 64, 1)] + [
    c for latent in (32, 64) for c in path_calls(4, latent=latent) if c.kernel == "ffn_block"] + [
    c for latent in (32, 64) for batch in (1, 4)
    for c in path_calls(batch, latent=latent, int8=True) if c.kernel.endswith("_int8")] + [
    _BWD_OF(c) for latent in (32, 64) for c in path_calls(1, latent=latent)] + [
    c for latent in (32, 64) for c in train_calls(8, latent=latent) if c.kernel.endswith("_bwd")]


@pytest.mark.cuda
@pytest.mark.parametrize("call", FP32_TC_CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_fp32_tensor_core_routes_match_plain_rerun_bitwise_inside_their_buffers(
        card, monkeypatch, call):
    """fp32 block_core and ffn_block (fp32 and int8 FFN weights), window
    MHA forward and both backward kernels at the sampling and train
    shapes: the tensor-core route taken (its
    predicate; the launch chains themselves:
    test_block_core_route_depends_on_shape_alone,
    test_window_mha_route_depends_on_shape_alone,
    test_ffn_route_depends_on_shape_alone), every buffer the wrapper
    allocates between sentinel guards (none changed, the split counters
    back to 0), two reruns with the same bits, and the plain version
    within 1e-4 (a backward output within BWD_REL of its scale; an
    ffn_block_bwd ReLU decision the two took apart within the fp32 sum's
    bound of 0 taken from the kernel, as workloads says)."""
    bwd = call.kernel.endswith("_bwd")
    mod, kernel, plain = (BWD_WRAPPERS if bwd else WRAPPERS)[call.kernel]
    gen = torch.Generator(device=card).manual_seed(24)
    args = make_inputs(call, torch.float32, card, gen)
    n = call.batch * call.hw * call.hw
    if call.kernel.startswith("window_mha"):
        args = args + (call.heads,)
        lib = _build.load("window_attention")
        route = lib.window_mha_bwd_tensor_cores if bwd else lib.window_mha_tensor_cores
        assert route(0, call.l, call.c, call.heads) == 1
    elif bwd:
        assert _build.load("ffn_block_bwd").ffn_bwd_tensor_cores(0, n, call.c, call.c) == 1
    elif call.kernel.startswith("ffn_block"):
        assert _build.load("ffn_block").ffn_tensor_cores(0, n, call.c, call.c) == 1
    else:
        q = int(call.kernel.endswith("_int8"))
        assert _build.load("block_core").block_core_tensor_cores(0, q, n, call.c, call.c) == 1
    count = ("bwd_launches" if bwd else
             "int8_launches" if call.kernel.endswith("_int8") else "launches")
    with torch.no_grad():
        before = getattr(mod, count)
        # split counters: block_core keeps ffn_block's
        monkeypatch.setattr(tattn if call.kernel.startswith("window_mha") else tffn,
                            "_counters", {})
        with GuardedBuffers() as guarded:
            first = kernel(*args)
            torch.cuda.synchronize()
        monkeypatch.undo()
        assert getattr(mod, count) == before + 1
        assert guarded.made and guarded.faults() == []
        first = first if isinstance(first, tuple) else (first,)
        for _ in range(2):
            again = kernel(*args)
            again = again if isinstance(again, tuple) else (again,)
            for i, (a, b) in enumerate(zip(first, again)):
                assert torch.equal(a, b), i
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        if call.kernel == "ffn_block_bwd" and any(
                bwd_scale_err(g, w) > BWD_REL[torch.float32] for g, w in zip(first, want)):
            want, differ, away, _ = ffn_bwd_boundary_plain(kernel, plain, args)
            print(call.label, differ, "ReLU decisions taken apart,", away, "away")
            assert away == 0
    for i, (g, w) in enumerate(zip(first, want)):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, i
        if bwd:
            assert bwd_scale_err(g, w) <= BWD_REL[torch.float32], i
        else:
            torch.testing.assert_close(g, w, **TOL[torch.float32])


@pytest.mark.cuda
def test_block_core_refuses_misaligned_inputs_on_the_tensor_cores(card):
    """The tensor-core route reads x, the film rows, the weight matrices
    and the conv taps in 16-byte chunks: one of them 2 bytes (or, int8,
    1 byte) off a 16-byte boundary is refused."""
    gen = torch.Generator(device=card).manual_seed(20)
    for kernel, which in (("block_core", 0), ("block_core", 15), ("block_core_int8", 3)):
        args = list(make_inputs(Call(kernel, 1, 8, 128, 1), torch.bfloat16, card, gen))
        t = args[which]
        raw = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        args[which] = raw[1:].view(t.shape).copy_(t)
        with torch.no_grad(), pytest.raises(ValueError):
            tbc.block_core(*args)


@pytest.mark.cuda
def test_block_core_gradients_on_the_tensor_core_route(card):
    """bf16 at a tensor-core shape: the gradients through the card path
    (forward on the tensor cores, the composed backward) against autograd
    through the plain version on the card, each within workloads.BWD_REL
    of its scale."""
    gen = torch.Generator(device=card).manual_seed(18)
    args = make_inputs(Call("block_core", 1, 8, 128, 1), torch.bfloat16, card, gen)
    cot = [torch.randn(args[0].shape, generator=gen, device=card).to(torch.bfloat16)
           for _ in range(2)]
    grads = []
    for fn in (tbc.block_core, tbc.block_core_plain):
        leaves = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
        torch.autograd.backward(fn(*leaves), cot)
        grads.append([t.grad for t in leaves if t.requires_grad])
    assert len(grads[0]) == len(grads[1]) == 17
    for i, (g, w) in enumerate(zip(*grads)):
        assert bwd_scale_err(g, w) <= BWD_REL[torch.bfloat16], i


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    gen = torch.Generator(device=card).manual_seed(2)
    args = make_inputs(Call("ffn_block", 1, 4, 128, 1), torch.float16, card, gen)
    with pytest.raises(TypeError):
        tffn.ffn_block(*args)
    args = list(make_inputs(Call("ffn_block", 1, 4, 128, 1), torch.float32,
                            card, gen))
    args[0] = args[0].t().contiguous().t()  # same shape, not contiguous
    with pytest.raises(ValueError):
        tffn.ffn_block(*args)
    # bf16 on the tensor-core route: contiguous, but 2 bytes off a 16-byte
    # boundary
    args = list(make_inputs(Call("ffn_block", 1, 4, 128, 1), torch.bfloat16, card, gen))
    x = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16, device=card)
    args[0] = x[1:].view(args[0].shape).copy_(args[0])
    with pytest.raises(ValueError):
        tffn.ffn_block(*args)
    bwd = list(make_inputs(Call("ffn_block_bwd", 1, 4, 128, 1), torch.bfloat16, card, gen))
    bwd[1] = x[1:].view(bwd[1].shape).copy_(bwd[1])
    with pytest.raises(ValueError):
        tffn.ffn_block_bwd(*bwd)
    # int8 weights: a matrix 1 byte off a 16-byte boundary on the
    # tensor-core route; a bias that is not [2, out] scale-bias rows; fp32
    # rows that are not fp32; and grad mode on
    with torch.no_grad():
        q = list(make_inputs(Call("ffn_block_int8", 1, 4, 128, 1), torch.bfloat16, card, gen))
        raw = torch.empty(q[3].numel() + 1, dtype=torch.int8, device=card)
        bad = list(q)
        bad[3] = raw[1:].view(q[3].shape).copy_(q[3])
        with pytest.raises(ValueError):
            tffn.ffn_block(*bad)
        bad = list(q)
        bad[4] = q[4][1].contiguous()
        with pytest.raises(ValueError):
            tffn.ffn_block(*bad)
        bad = list(q)
        bad[4] = q[4].to(torch.bfloat16)
        with pytest.raises(TypeError):
            tffn.ffn_block(*bad)
        bc = list(make_inputs(Call("block_core_int8", 1, 4, 128, 1), torch.float32, card, gen))
        bc[8] = bc[8][..., 1, :].contiguous()  # gbc without its scale row
        with pytest.raises(ValueError):
            tbc.block_core(*bc)
    # grad mode on (formerly refused, ROADMAP A15): the full-precision
    # weights with int8=(their int8 forms, their dequantized copies), as
    # RandomMoE passes them, run the int8 chain forward and the backward
    # kernel at the dequantized copies, every gradient that of the plain
    # version there; int8 weights given directly still refuse grad mode
    fp = make_inputs(Call("ffn_block", 1, 4, 128, 1), torch.bfloat16, card, gen)
    leaves = [a.detach().requires_grad_() for a in fp[:15]]
    qw = tffn.quantize_ffn(leaves[3:])
    dq = tffn.dequantize_ffn(qw, torch.bfloat16)
    before = (tffn.int8_launches, tffn.bwd_launches, tffn.launches)
    out = tffn.ffn_block(*leaves, fp[15], int8=(qw, dq))[0]
    got = torch.autograd.grad(out.float().sum(), [leaves[0], *leaves[3:]])
    assert (tffn.int8_launches, tffn.bwd_launches, tffn.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    at = [d.detach().requires_grad_() for d in dq]
    want = torch.autograd.grad(
        tffn.ffn_block_plain(leaves[0], *leaves[1:3], *at, fp[15])[0].float().sum(),
        [leaves[0], *at])
    for g, w in zip(got, want):
        assert bwd_scale_err(g, w) <= BWD_REL[torch.bfloat16]
    with pytest.raises(ValueError, match="grad mode off only"):
        tffn.ffn_block(*q)


# the ffn_block calls of an int8 train step: B=8 (ffn_block, as
# train_calls) and B=2 (block_core)
INT8_TRAIN_CALLS = [c for c in train_calls(8) if c.kernel == "ffn_block"] + [
    c for c in path_calls(2) if c.kernel == "block_core"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", INT8_TRAIN_CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_int8_backward_at_the_train_shapes(card, call, dtype):
    """Training through int8 weights at the train step's shapes: the
    wrapper with full-precision weights and their int8 copies (made on
    the card) launches the int8 forward and the backward kernel once
    each, and its gradients in every differentiable input equal autograd
    through the plain version at the dequantized weights (the
    straight-through contract), each within workloads.BWD_REL of its
    scale."""
    gen = torch.Generator(device=card).manual_seed(22)
    args = make_inputs(call, dtype, card, gen)
    core = call.kernel == "block_core"
    mod, fn, plain = (tbc, tbc.block_core, tbc.block_core_plain) if core else (
        tffn, tffn.ffn_block, tffn.ffn_block_plain)
    leaves = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
    qw = tffn.quantize_ffn(leaves[3:15])
    dq = tffn.dequantize_ffn(qw, dtype)
    cot = [torch.randn(args[0].shape, generator=gen, device=card).to(dtype)
           for _ in range(2)]
    before = (mod.int8_launches, mod.launches, tffn.bwd_launches)
    torch.autograd.backward(fn(*leaves, int8=(qw, dq)), cot)
    assert (mod.int8_launches, mod.launches, tffn.bwd_launches) == (
        before[0] + 1, before[1], before[2] + 1)
    got = [t.grad for t in leaves if t.requires_grad]
    ref = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
    ref[3:15] = [d.detach().requires_grad_() for d in dq]
    torch.autograd.backward(plain(*ref), cot)
    want = [t.grad for t in ref if t.requires_grad]
    assert len(got) == len(want) == (17 if core else 15)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert bwd_scale_err(g, w) <= BWD_REL[dtype], i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_on_dequantized_weights(card, monkeypatch, dtype):
    """ffn_block_bwd on int8 round-tripped weights at the B=8 train
    shapes (workloads.dequantized_bwd_inputs): against its plain version,
    rerun bitwise, and writing only inside its buffers."""
    gen = torch.Generator(device=card).manual_seed(23)
    for call in (c for c in train_calls(8) if c.kernel == "ffn_block_bwd"):
        args = dequantized_bwd_inputs(make_inputs(call, dtype, card, gen))
        got = tffn.ffn_block_bwd(*args)
        for g, w in zip(got, tffn.ffn_block_bwd_plain(*args)):
            assert bwd_scale_err(g, w) <= BWD_REL[dtype], call.label
        assert all(torch.equal(a, b) for a, b in zip(tffn.ffn_block_bwd(*args), got))
        monkeypatch.setattr(tffn, "_counters", {})
        with GuardedBuffers() as guarded:
            again = tffn.ffn_block_bwd(*args)
            torch.cuda.synchronize()
        monkeypatch.undo()
        assert guarded.made and guarded.faults() == []
        assert all(torch.equal(a, b) for a, b in zip(again, got))


VQ_CALLS = vae_train_calls() + [
    Call("vq", 1, 0, 8, 1, n=700, l=300),       # ragged rows, few codes
    Call("vq", 1, 0, 8, 1, n=37, l=8192),       # one row block, many slices
    Call("vq", 1, 0, 8, 1, n=4608, l=8191),     # a ragged slice and tile
    Call("vq", 1, 0, 8, 1, n=4608, l=300),      # short slices, a ragged tile
    Call("vq", 1, 0, 8, 1, n=1, l=8192),        # one row
    Call("vq", 1, 0, 8, 1, n=17, l=8192),       # one m-tile and a row
    Call("vq", 1, 0, 8, 1, n=4609, l=8192),     # the VAE step and a row
]


def _vq_indices(x, codebook):
    """The kernel's indices, checked to take one launch and to rerun
    bitwise."""
    before = tvq.launches
    got = tvq.nearest_codebook_indices(x, codebook)
    assert tvq.launches == before + 1
    assert torch.equal(tvq.nearest_codebook_indices(x, codebook), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", VQ_CALLS, ids=lambda c: c.label)
def test_vq_kernel_matches_plain(card, call, dtype):
    """The kernel's indices equal the plain version's, except at a
    near-tie (workloads.VQ_TIE_REL), and a rerun gives the same bits."""
    gen = torch.Generator(device=card).manual_seed(6)
    x, codebook = make_inputs(call, dtype, card, gen)
    got = _vq_indices(x, codebook)
    want = tvq.nearest_codebook_indices_plain(x, codebook)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (call.n,)
    assert ((got >= 0) & (got < call.l)).all()
    n, gap = vq_mismatches(x, codebook, got, want)
    print(call.label, dtype, "mismatches", n, "largest gap", gap)
    assert gap <= VQ_TIE_REL, (n, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vq_kernel_matches_plain_on_near_ties(card, dtype):
    """At the VAE step's shape on workloads.near_tie_codebook (pairs 2**-18
    apart, exact duplicates K/2 on): equal to the plain version except
    within VQ_TIE_REL, never a second copy of a duplicate."""
    gen = torch.Generator(device=card).manual_seed(8)
    (call,) = vae_train_calls()
    x = torch.randn((call.n, call.c), generator=gen, device=card).to(dtype)
    codebook = near_tie_codebook(call.l, call.c, gen, card)
    got = _vq_indices(x, codebook)
    n, gap = vq_mismatches(x, codebook, got, tvq.nearest_codebook_indices_plain(x, codebook))
    print(dtype, "near-tie mismatches", n, "largest gap", gap)
    assert gap <= VQ_TIE_REL, (n, gap)
    assert (got < call.l // 2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["halves", "next_rank", "mid", "quad", "pair"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vq_kernel_takes_the_first_index_on_exact_ties(card, dtype, layout):
    """Exact duplicates (K = 8192, N = 4608) half the codebook on, in the
    next cluster rank's slice (the kernel's own split, vq_slice_codes), in
    the other warp half of the same rank's slice, in lanes 2-3 of the quad
    holding their first copy and in the same lane's code pair: never the
    second copy; on halves, equal to the kernel's answer on the first half
    alone."""
    gen = torch.Generator(device=card).manual_seed(7)
    slice_codes = _build.load("vq").vq_slice_codes(4608, 8192)
    assert 0 < slice_codes < 8192
    codebook, copy_of = tie_codebook(8192, 8, layout, gen, card, slice_codes)
    x = torch.randn((4608, 8), generator=gen, device=card).to(dtype)
    got = _vq_indices(x, codebook).long()
    assert torch.equal(copy_of[got], got)
    n, gap = vq_mismatches(x, codebook, got, tvq.nearest_codebook_indices_plain(x, codebook))
    assert gap <= VQ_TIE_REL, (n, gap)
    if layout == "halves":
        assert torch.equal(got, _vq_indices(x, codebook[:4096].contiguous()).long())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", VQ_CALLS, ids=lambda c: c.label)
def test_vq_writes_only_inside_its_buffers(card, call, dtype):
    """The kernel's output between sentinel guards: no guard written, and
    the indices bitwise equal to an unguarded call's."""
    gen = torch.Generator(device=card).manual_seed(9)
    x, codebook = make_inputs(call, dtype, card, gen)
    want = _vq_indices(x, codebook)
    with GuardedBuffers() as guarded:
        got = tvq.nearest_codebook_indices(x, codebook)
        torch.cuda.synchronize()
    assert guarded.made and guarded.faults() == []
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_vq_wrapper_raises_on_what_the_kernel_does_not_take(card):
    x = torch.randn((64, 8), device=card)
    cb = torch.randn((128, 8), device=card)
    with pytest.raises(TypeError):
        tvq.nearest_codebook_indices(x.half(), cb)
    with pytest.raises(TypeError):
        tvq.nearest_codebook_indices(x, cb.bfloat16())
    with pytest.raises(ValueError):
        tvq.nearest_codebook_indices(x.t().contiguous().t(), cb)  # not contiguous
    with pytest.raises(ValueError):
        tvq.nearest_codebook_indices(x[:, :4].contiguous(), cb[:, :4].contiguous())
    with pytest.raises(ValueError):  # indices past 2**24 are not exact in fp32
        tvq.nearest_codebook_indices(x, torch.empty((tvq.KERNEL_MAX_CODES + 1, 8), device=card))
