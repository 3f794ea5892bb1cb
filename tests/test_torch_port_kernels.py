"""The port's kernel modules against the JAX package: each plain PyTorch
version against the JAX *_xla composition and the Pallas kernel in
interpret mode (CPU, fp32, C=128), plus the CPU dispatch of each wrapper.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_port_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.kernels import block_core as jbc
from ldm_image_generator_tpu.kernels import ffn_block as jffn
from ldm_image_generator_tpu.kernels import window_attention as jattn
from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.kernels import window_attention as tattn

torch.set_num_threads(1)

# fp32 on the CPU (tests/test_models_parity.py); the Pallas interpret
# runs sum the FFN/conv products in another order than XLA, so their
# comparison takes the tolerance of tests/test_block_core_kernel.py
TOL = dict(rtol=5e-4, atol=5e-5)
TOL_PALLAS = dict(rtol=5e-4, atol=5e-4)
# bf16, plain version vs the Pallas kernel in interpret mode: both round
# h, the gate and the output to bf16 at the same points from fp32 sums
# of the same products, so a value may differ only where the sums' order
# moved it across a rounding boundary: by one bf16 ulp, at most 2**-7 of
# its magnitude (2**-14 absolute near 0, below the outputs' ulp)
TOL_BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -14)


def _ffn_inputs(rows, c=128, m=128, e=4, film_rows=None, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=0.05: (rng.normal(size=s) * scale).astype(np.float32)
    fr = film_rows or rows
    x = r(rows, c, scale=1.0)
    mul = r(fr, c, scale=0.2) + 1.0
    bias = r(fr, c, scale=0.2)
    w = (r(c, m), r(m), r(c, m), r(m), r(m, c), r(c),
         r(e, c, m), r(e, m), r(e, c, m), r(e, m), r(e, m, c), r(e, c))
    return x, mul, bias, w


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


# (ids, dtype) cases; the fp32 ones keep their ids
DTYPE_CASES = [((1, 3), "float32"), ((0, 2), "float32"),
               ((1, 3), "bfloat16"), ((0, 2), "bfloat16")]
DTYPE_CASE_IDS = ["ids0", "ids1", "ids0-bf16", "ids1-bf16"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("ids,dtype", DTYPE_CASES, ids=DTYPE_CASE_IDS)
def test_ffn_block_plain_matches_xla_and_pallas(ids, dtype):
    """fp32: the plain version against the XLA composition and the Pallas
    kernel (interpret). bf16 (inputs rounded alike on both sides): against
    the Pallas kernel, whose rounding points the CUDA kernels share (the
    XLA composition rounds every product in bf16 instead)."""
    x, mul, bias, w = _ffn_inputs(rows=32)
    tt = [t.to(getattr(torch, dtype)) for t in _t(x, mul, bias, *w)]
    jj = [a.astype(getattr(jnp, dtype)) for a in _j(x, mul, bias, *w)]
    out, h = tffn.ffn_block_plain(*tt, torch.tensor(ids, dtype=torch.int32))
    if dtype == "float32":
        ref_out, ref_h = jffn.ffn_block_xla(*jj, *ids)
        np.testing.assert_allclose(_np(h), np.asarray(ref_h), **TOL)
        np.testing.assert_allclose(_np(out), np.asarray(ref_out), **TOL)
    p_out, p_h = jffn.ffn_block_pallas(*jj, jnp.asarray(ids, jnp.int32),
                                       interpret=True)
    tol = TOL_PALLAS if dtype == "float32" else TOL_BF16
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    np.testing.assert_allclose(_np(h), f32(p_h), **tol)
    np.testing.assert_allclose(_np(out), f32(p_out), **tol)


def test_ffn_block_periodic_film_rows_match_broadcast():
    """Film rows [F, C] repeat over N = k * F rows (the batch-1 FiLM
    schedule at batch k) exactly as the materialized broadcast."""
    x, mul, bias, w = _ffn_inputs(rows=48, film_rows=16)
    ids = torch.tensor((2, 3), dtype=torch.int32)
    out, h = tffn.ffn_block(*_t(x, mul, bias, *w), ids)
    rep = lambda a: np.tile(a, (3, 1))
    ref_out, ref_h = jffn.ffn_block_xla(*_j(x, rep(mul), rep(bias), *w), 2, 3)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)


def _block_inputs(b=1, hw=4, c=128, film_b=1, seed=1):
    x, mul, bias, w = _ffn_inputs(rows=b * hw * hw, c=c, m=c,
                                  film_rows=film_b * hw * hw, seed=seed)
    rng = np.random.default_rng(seed + 100)
    ck = (rng.normal(size=(3, 3, 32, c)) * 0.1).astype(np.float32)
    cb = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    shape = lambda a, bb: a.reshape(bb, hw, hw, c)
    return shape(x, b), shape(mul, film_b), shape(bias, film_b), w, ck, cb


@pytest.mark.parametrize("add_residual", [True, False])
def test_block_core_plain_matches_xla_and_pallas(add_residual):
    x, mul, bias, w, ck, cb = _block_inputs()
    out, h = tbc.block_core_plain(*_t(x, mul, bias, *w, ck, cb),
                                  torch.tensor((1, 3), dtype=torch.int32),
                                  add_residual=add_residual)
    ref_out, ref_h = jbc.block_core_xla(*_j(x, mul, bias, *w, ck, cb), 1, 3,
                                        add_residual=add_residual)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    p_out, p_h = jbc.block_core_pallas(*_j(x, mul, bias, *w, ck, cb),
                                       jnp.asarray((1, 3), jnp.int32),
                                       add_residual=add_residual,
                                       interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(p_h), **TOL_PALLAS)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out), **TOL_PALLAS)


@pytest.mark.parametrize("add_residual", [True, False])
def test_block_core_plain_matches_pallas_bf16(add_residual):
    """bf16 (inputs rounded alike on both sides): the plain version against
    the Pallas kernel (interpret), whose rounding points the CUDA kernels
    share: h and the gate rounded to bf16, the FFN towers, the grouped
    conv of bf16 h, its bias and the residual summed in fp32 and rounded
    once."""
    x, mul, bias, w, ck, cb = _block_inputs()
    ids = (1, 3)
    tt = [t.to(torch.bfloat16) for t in _t(x, mul, bias, *w, ck, cb)]
    jj = [a.astype(jnp.bfloat16) for a in _j(x, mul, bias, *w, ck, cb)]
    out, h = tbc.block_core_plain(*tt, torch.tensor(ids, dtype=torch.int32),
                                  add_residual=add_residual)
    p_out, p_h = jbc.block_core_pallas(*jj, jnp.asarray(ids, jnp.int32),
                                       add_residual=add_residual,
                                       interpret=True)
    assert out.dtype == h.dtype == torch.bfloat16
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    np.testing.assert_allclose(_np(h), f32(p_h), **TOL_BF16)
    np.testing.assert_allclose(_np(out), f32(p_out), **TOL_BF16)


def _attn_inputs(n=3, l=36, c=128, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, l, c)).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.05).astype(np.float32)
          for s in [(c, c), (c,)] * 4]
    mask = np.zeros((n, l), bool)
    mask[:, 30:] = True  # padded keys, as a window over the map's edge
    mask[0, :] = False
    return x, mask, ws


@pytest.mark.parametrize("masked", [True, False])
def test_window_mha_plain_matches_xla_and_pallas(masked):
    x, mask, ws = _attn_inputs()
    m = mask if masked else None
    out = tattn.window_mha_plain(*_t(x), None if m is None else _t(m)[0],
                                 *_t(*ws), num_heads=4)
    ref = jattn.window_mha_xla(jnp.asarray(x), None if m is None else jnp.asarray(m),
                               *_j(*ws), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    pal = jattn.window_mha_pallas(jnp.asarray(x),
                                  None if m is None else jnp.asarray(m),
                                  *_j(*ws), num_heads=4, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), **TOL_PALLAS)


def test_cpu_wrappers_take_plain_versions_and_count_no_launch():
    x, mask, ws = _attn_inputs(n=2)
    before = (tattn.launches, tbc.launches, tffn.launches)
    np.testing.assert_array_equal(
        tattn.window_mha(*_t(x, mask), *_t(*ws), num_heads=4).numpy(),
        tattn.window_mha_plain(*_t(x, mask), *_t(*ws), num_heads=4).numpy())
    bx, bm, bb, w, ck, cb = _block_inputs()
    ids = torch.tensor((0, 1), dtype=torch.int32)
    for a, b in zip(tbc.block_core(*_t(bx, bm, bb, *w, ck, cb), ids),
                    tbc.block_core_plain(*_t(bx, bm, bb, *w, ck, cb), ids)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (tattn.launches, tbc.launches, tffn.launches) == before


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path, which raises here
    (meta tensors have no data); it never falls back quietly."""
    x, mul, bias, w = _ffn_inputs(rows=16)
    meta = [t.to("meta") for t in _t(x, mul, bias, *w)]
    ids = torch.tensor((0, 1), dtype=torch.int32, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        tffn.ffn_block(*meta, ids)


def test_trace_kernels_lists_every_path_shape_of_every_kernel():
    """The trace CLI covers every kernel at every call shape of its paths:
    batch-1 and batch-4 sampling (with int8 FFN weights too), the backward
    kernels of the B=1 train step, the B=8 train step (forward and
    backward) and the VAE step, the window MHA ones at head dim 32 and L
    <= 64 (the tensor-core shapes); it refuses to run without a card."""
    from ldm_image_generator_tpu_torch.cli import trace_kernels

    calls = trace_kernels.calls_of(sorted(trace_kernels.KERNELS))
    assert sorted({(tag, c.kernel) for tag, c in calls}) == [
        ("b1", "block_core"), ("b1", "block_core_int8"), ("b1", "window_mha"),
        ("b4", "ffn_block"), ("b4", "ffn_block_int8"),
        ("b4", "window_mha"), ("train", "ffn_block"),
        ("train", "ffn_block_bwd"), ("train", "window_mha"),
        ("train", "window_mha_bwd"), ("train_b1", "ffn_block_bwd"),
        ("train_b1", "window_mha_bwd"), ("vae_train", "vq")]
    assert len(calls) == 6 * 8 + 1
    mha = [c for _, c in calls if c.kernel.startswith("window_mha")]
    assert len(mha) == 20
    assert all(c.c == 32 * c.heads and c.l <= 64 for c in mha)
    if not torch.cuda.is_available():
        assert trace_kernels.main([]) == 1


def test_vq_breakdown_builds_each_part_of_the_loop_out_once():
    """The vq breakdown times the full kernel and one build per part of
    its main loop taken out (csrc/vq.cu VQ_DROP: products, compare, both,
    the whole loop), each build once; it refuses to run without a card."""
    from ldm_image_generator_tpu_torch.cli import vq_breakdown

    assert vq_breakdown.BUILDS["full"] == 0
    assert sorted(vq_breakdown.BUILDS.values()) == [0, 1, 2, 3, 4]
    src = (vq_breakdown._build.CSRC / "vq.cu").read_text()
    assert "#ifndef VQ_DROP\n#define VQ_DROP 0\n#endif" in src
    if not torch.cuda.is_available():
        assert vq_breakdown.main([]) == 1


def test_sass_counts_reads_cuobjdump_and_ptxas_output():
    """The SASS report pairs each kernel's HMMA and FFMA counts (FFMA.FTZ
    counted, HMMA's own operands not) with ptxas's registers, stack frame
    and spills."""
    from ldm_image_generator_tpu_torch.cli import sass_counts

    log = ("ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1av\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers\n")
    assert sass_counts.ptxas_report(log) == {"_Z1av": (168, 8, 4, 4),
                                             "_Z1bv": (40, 0, 0, 0)}
    sass = ("\tcode for sm_90a\n\t\tFunction : _Z1av\n"
            "  /*0010*/ HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            "  /*0020*/ HMMA.16816.F32.BF16 R8, R8, R14, R8 ;\n"
            "  /*0030*/ FFMA R1, R2, R3, R4 ;\n"
            "\t\tFunction : _Z1bv\n"
            "  /*0010*/ FFMA.FTZ R1, R2, R3, R4 ;\n  /*0020*/ FMUL R1, R2, R3 ;\n")
    assert sass_counts.sass_counts(sass) == {"_Z1av": (2, 1), "_Z1bv": (0, 1)}
