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
from ldm_image_generator_tpu_torch.kernels import window_attention as tattn
from ldm_image_generator_tpu_torch.kernels.workloads import (
    Call,
    make_inputs,
    path_calls,
)

torch.set_num_threads(1)

WRAPPERS = {
    "block_core": (tbc, tbc.block_core, tbc.block_core_plain),
    "ffn_block": (tffn, tffn.ffn_block, tffn.ffn_block_plain),
    "window_mha": (tattn, lambda *a: tattn.window_mha(*a[:-1], num_heads=a[-1]),
                   lambda *a: tattn.window_mha_plain(*a[:-1], num_heads=a[-1])),
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
