"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips elsewhere. This file imports
neither JAX nor the JAX package, so on a machine without JAX run it
without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_port_cuda.py
"""
import pytest
import torch

from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.kernels import vq as tvq
from ldm_image_generator_tpu_torch.kernels import window_attention as tattn
from ldm_image_generator_tpu_torch.kernels.workloads import (
    BWD_REL,
    VQ_TIE_REL,
    Call,
    bwd_scale_err,
    make_inputs,
    path_calls,
    train_calls,
    vae_train_calls,
    vq_mismatches,
)

torch.set_num_threads(1)

WRAPPERS = {
    "block_core": (tbc, tbc.block_core, tbc.block_core_plain),
    "ffn_block": (tffn, tffn.ffn_block, tffn.ffn_block_plain),
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


CALLS = [c for c in path_calls(1) + path_calls(4)] + [
    Call("block_core", 2, 5, 64, 1),        # odd map, C below 128, 2 images
    Call("window_mha", 1, 0, 64, 1, n=3, l=36, heads=2, masked=True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_kernel_matches_plain(card, call, dtype):
    mod, kernel, plain = WRAPPERS[call.kernel]
    gen = torch.Generator(device=card).manual_seed(0)
    args = make_inputs(call, dtype, card, gen)
    if call.kernel == "window_mha":
        args = args + (call.heads,)
    before = mod.launches
    got = kernel(*args)
    assert mod.launches == before + 1
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
    Call("window_mha_bwd", 1, 0, 64, 1, n=3, l=36, heads=2, masked=True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", BWD_CALLS, ids=lambda c: f"{c.kernel}{c.label}")
def test_backward_kernel_matches_plain(card, call, dtype):
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
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.isfinite(g).all(), i
        rel = bwd_scale_err(g, w)
        print(call.kernel, call.label, dtype, i, rel)
        assert rel <= BWD_REL[dtype], (i, rel)


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
    backward launches the backward kernels."""
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


VQ_CALLS = vae_train_calls() + [
    Call("vq", 1, 0, 8, 1, n=700, l=300),       # ragged rows, few codes
    Call("vq", 1, 0, 8, 1, n=37, l=8192),       # one row block, many slices
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", VQ_CALLS, ids=lambda c: c.label)
def test_vq_kernel_matches_plain(card, call, dtype):
    """The kernel's indices equal the plain version's, except at a
    near-tie (workloads.VQ_TIE_REL), and a rerun gives the same bits."""
    gen = torch.Generator(device=card).manual_seed(6)
    x, codebook = make_inputs(call, dtype, card, gen)
    before = tvq.launches
    got = tvq.nearest_codebook_indices(x, codebook)
    assert tvq.launches == before + 1
    want = tvq.nearest_codebook_indices_plain(x, codebook)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (call.n,)
    assert ((got >= 0) & (got < call.l)).all()
    n, gap = vq_mismatches(x, codebook, got, want)
    print(call.label, dtype, "mismatches", n, "largest gap", gap)
    assert gap <= VQ_TIE_REL, (n, gap)
    assert torch.equal(tvq.nearest_codebook_indices(x, codebook), got)


@pytest.mark.cuda
def test_vq_kernel_takes_the_first_index_on_exact_ties(card):
    """A codebook of two equal halves (K = 8192): every index is in the
    first half and equal to the kernel's answer on that half alone."""
    gen = torch.Generator(device=card).manual_seed(7)
    half = torch.randn((4096, 8), generator=gen, device=card)
    x = torch.randn((4608, 8), generator=gen, device=card)
    got = tvq.nearest_codebook_indices(x, torch.cat([half, half]))
    assert (got < 4096).all()
    assert torch.equal(got, tvq.nearest_codebook_indices(x, half))
    n, gap = vq_mismatches(x, half, got, tvq.nearest_codebook_indices_plain(x, half))
    assert gap <= VQ_TIE_REL, (n, gap)


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
