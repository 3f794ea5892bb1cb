"""The port's int8 FFN-weight sampling against the JAX package (CPU): the
quantization scheme, the int8 routes' plain versions against the Pallas
kernels in interpret mode (quantized=True), a tiny int8 UNet step and an
int8 pipeline sample against the JAX package's fake-quant XLA route, the
straight-through gradient, grad mode through int8 weights and the CLI;
then the pipeline's cast copies (the caller's modules unchanged) and the
config fields the UNet refuses. Training through int8 weights against
JAX: tests/test_torch_port_int8_train.py. The CUDA int8 kernels are held against these
plain versions on the card by tests/test_torch_port_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.kernels import block_core as jbc
from ldm_image_generator_tpu.kernels import ffn_block as jffn
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.pipelines import LDMPipeline as JPipeline
from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import decoder_from_flax, unet_from_flax
from ldm_image_generator_tpu_torch.kernels import block_core as tbc
from ldm_image_generator_tpu_torch.kernels import ffn_block as tffn
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import Decoder
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

torch.set_num_threads(1)

# fp32 on the CPU (tests/test_models_parity.py)
TOL = dict(rtol=5e-4, atol=5e-5)
# bf16, plain version vs the Pallas kernel: both round h, the gate and the
# output at the same points from fp32 sums of the same exact products
# (|q| <= 127 is exact in bf16), so a value may differ only where the
# sums' order moved it across a rounding boundary: by one bf16 ulp
TOL_BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -14)
IMAGE, STEPS = 16, 4   # tiny VAE: an 8x8 latent
INT8 = dict(ffn_quant="int8", fixed_expert_indices=(0, 1))


def _ffn_weights(c, m, e=4, seed=0):
    """The 12 FFN weights (lecun-scale matrices, random biases), fp32 numpy."""
    rng = np.random.default_rng(seed)
    w = lambda *s, fan: (rng.normal(size=s) / np.sqrt(fan)).astype(np.float32)
    b = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)
    return (w(c, m, fan=c), b(m), w(c, m, fan=c), b(m), w(m, c, fan=m), b(c),
            w(e, c, m, fan=c), b(e, m), w(e, c, m, fan=c), b(e, m),
            w(e, m, c, fan=m), b(e, c))


def _jq(weights):
    """The JAX package's quantize_cols of each (matrix, bias) pair as the
    jitted Pallas call computes it, as torch tensors in the port's order
    (int8 matrix, fp32 rows). Under jit XLA divides by 127 as a product
    with its reciprocal, so a scale may sit one ulp from the eager
    division's, which the port's quantize_cols matches."""
    quantize = jax.jit(jffn.quantize_cols)
    out = []
    for wt, bs in zip(weights[0::2], weights[1::2]):
        out += [torch.from_numpy(np.array(a)) for a in quantize(wt, bs)]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_cols_matches_jax(dtype):
    """int8 values and [scale; bias] rows equal the JAX package's, for a
    [C, M] matrix and stacked [E, C, M] experts, quantized from weights
    already in the compute dtype. A value may differ by 1 only where
    w / scale lies within 1e-6 of a half-integer (the two divisions may
    round there apart); the count of such values is reported."""
    w = _ffn_weights(128, 128)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    near = 0
    for wt, bs in ((w[0], w[1]), (w[6], w[7])):
        jw, jb = jnp.asarray(wt).astype(jt), jnp.asarray(bs).astype(jt)
        want_q, want_sb = (np.asarray(a) for a in jffn.quantize_cols(jw, jb))
        got_q, got_sb = tffn.quantize_cols(torch.from_numpy(wt).to(tt),
                                           torch.from_numpy(bs).to(tt))
        assert got_q.dtype == torch.int8 and got_sb.dtype == torch.float32
        assert got_sb.shape == want_sb.shape == (*wt.shape[:-2], 2, wt.shape[-1])
        np.testing.assert_array_equal(got_sb.numpy(), want_sb)
        ratio = np.asarray(jw.astype(jnp.float32)) / want_sb[..., :1, :]
        tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) <= 1e-6
        diff = got_q.numpy().astype(np.int32) - want_q.astype(np.int32)
        assert np.all((diff == 0) | ((np.abs(diff) == 1) & tie))
        near += int((diff != 0).sum())
    print(f"quantize_cols {dtype}: {near} values off by one at a half-integer")
    # dequantize_cols inverts it to within half a step of each column
    wdq, b = tffn.dequantize_cols(got_q, got_sb)
    step = got_sb[..., 0:1, :]
    assert bool(((wdq - torch.from_numpy(wt).to(tt).float()).abs() <= 0.5 * step + 1e-7).all())
    np.testing.assert_array_equal(b.numpy(), want_sb[..., 1, :])


@pytest.mark.parametrize("kernel", ["ffn_block", "block_core"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_pallas(kernel, dtype):
    """The plain int8 routes (ffn_block: N=64, C=M=128; block_core: B=2,
    8x8, C=128) against ffn_block_pallas / block_core_pallas with
    interpret=True, quantized=True, on the int8 weights and scales the
    Pallas call makes from the same weights (in the compute dtype)."""
    rng = np.random.default_rng(3)
    b, hw, c = (2, 8, 128) if kernel == "block_core" else (1, 8, 128)
    n = b * hw * hw if kernel == "block_core" else 64
    x = rng.normal(size=(n, c)).astype(np.float32)
    mul = (rng.normal(size=(n // b if kernel == "block_core" else n, c)) * 0.2
           + 1.0).astype(np.float32)
    bias = (rng.normal(size=mul.shape) * 0.2).astype(np.float32)
    w = _ffn_weights(c, c, seed=4)
    ck = (rng.normal(size=(3, 3, 32, c)) * 0.1).astype(np.float32)
    cb = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    j = lambda *a: [jnp.asarray(v).astype(jt) for v in a]
    t = lambda *a: [torch.from_numpy(v).to(tt) for v in a]
    jw = j(*w)
    tw = _jq(jw)
    ids = (1, 3)
    tids = torch.tensor(ids, dtype=torch.int32)
    if kernel == "ffn_block":
        got = tffn.ffn_block_plain(*t(x, mul, bias), *tw, tids)
        want = jffn.ffn_block_pallas(*j(x, mul, bias), *jw, jnp.asarray(ids, jnp.int32),
                                     interpret=True, quantized=True)
    else:
        img = lambda a, bb: a.reshape(bb, hw, hw, c)
        got = tbc.block_core_plain(*t(img(x, b), img(mul, 1), img(bias, 1)), *tw,
                                   *t(ck, cb), tids)
        want = jbc.block_core_pallas(*j(img(x, b), img(mul, 1), img(bias, 1)), *jw,
                                     *j(ck, cb), jnp.asarray(ids, jnp.int32),
                                     interpret=True, quantized=True)
    tol = TOL if dtype == "float32" else TOL_BF16
    for g, r in zip(got, want):
        assert g.dtype == tt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)).reshape(g.shape), **tol)


def _random_params(init, *args, seed):
    """Parameters of the shapes init(*args) makes (traced, not run: a
    flax init compiles for seconds), filled with seeded normals: biases
    at 0.05, every other tensor at 1 / sqrt(the product of its leading
    dimensions), so biases count and activations keep their scale."""
    rng = np.random.default_rng(seed)
    std = lambda shape: 0.05 if len(shape) == 1 else float(np.prod(shape[:-1])) ** -0.5
    return jax.tree.map(
        lambda a: jnp.asarray((rng.normal(size=a.shape) * std(a.shape)).astype(np.float32)),
        jax.eval_shape(init, *args))


np_tree = lambda p: jax.tree.map(np.asarray, p)


def test_int8_unet_step_matches_jax(monkeypatch):
    """A tiny UNet with ffn_quant='int8', one denoise step (fp32) against
    the JAX UNet on the CPU (its fake-quant XLA route), x drawn by numpy
    and the JAX apply's routing plan injected into the port."""
    jcfg = JUNetConfig(ffn_quant="int8").tiny()
    junet = JUNet(jcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(5).normal(size=(1, 8, 8, 8)).astype(np.float32)
    t = np.asarray([613], np.int32)
    params = _random_params(junet.init, {"params": key, "moe": key}, jnp.asarray(x),
                            jnp.asarray(t), seed=6)
    plans = []  # the routing plan the apply draws, returned beside its output
    randint = jax.random.randint

    def recording(k, shape, *a, **kw):
        plans.append(randint(k, shape, *a, **kw))
        return plans[-1]

    def apply(p, xx, tt, k):
        out = junet.apply(p, xx, tt, rngs={"moe": k})
        return out, plans[-1]

    monkeypatch.setattr(jax.random, "randint", recording)
    ref, plan = jax.jit(apply)(params, jnp.asarray(x), jnp.asarray(t), jax.random.PRNGKey(7))
    monkeypatch.undo()
    plan = np.array(plan)
    tunet = unet_from_flax(np_tree(params), UNetConfig(ffn_quant="int8").tiny(), device="cpu")
    with torch.no_grad():
        out = tunet(torch.from_numpy(x), torch.from_numpy(t),
                    moe_plan=torch.from_numpy(plan))
    assert plan.shape == (tunet.plan_length(),)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def int8_pipes():
    """(JAX pipeline and its params, port pipeline on the same weights):
    tiny config, int8 FFN weights, routing pinned to experts (0, 1), fp32."""
    ucfg = JUNetConfig(**INT8).tiny()
    jp = JPipeline(ucfg, JVAEConfig().tiny(), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1, 8, 8, ucfg.input_channels))
    up = _random_params(jp.unet.init, {"params": key, "moe": key}, z0,
                        jnp.zeros((1,), jnp.int32), seed=9)
    dp = _random_params(jp.decoder.init, key, z0, seed=10)
    tp = LDMPipeline(
        unet_from_flax(np_tree(up), UNetConfig(**INT8).tiny(), device="cpu"),
        decoder_from_flax(np_tree(dp), VAEConfig().tiny(), device="cpu"),
        dtype=torch.float32)
    return jp, up, dp, tp


def test_int8_sample_matches_jax_within_one_level(int8_pipes):
    """An int8 LDMPipeline sample against the JAX pipeline's (x_T from
    numpy): uint8 within 1; a sample call quantizes nothing (the
    pipeline made the int8 weights at construction)."""
    jp, up, dp, tp = int8_pipes
    noise = np.random.default_rng(8).normal(size=(2, 8, 8, 8)).astype(np.float32)
    ref = np.asarray(jp.sample(up, dp, jax.random.PRNGKey(1), batch=2, image_size=IMAGE,
                               num_steps=STEPS, init_noise=jnp.asarray(noise)))
    before = tffn.quantizations
    img = tp.sample(batch=2, image_size=IMAGE, num_steps=STEPS,
                    init_noise=torch.from_numpy(noise))
    assert tffn.quantizations == before
    assert img.dtype == torch.uint8 and img.shape == ref.shape == (2, IMAGE, IMAGE, 3)
    diff = np.abs(img.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()


def test_fake_quantize_straight_through_gradient():
    """fake_quantize: the JAX package's values, and gradients that pass
    straight through to the full-precision weights."""
    w, b = _ffn_weights(32, 16)[6:8]
    jw, jb = jffn.fake_quantize(jnp.asarray(w), jnp.asarray(b))
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    qw, qb = tffn.fake_quantize(tw, tb)
    np.testing.assert_array_equal(qw.detach().numpy(), np.asarray(jw))
    np.testing.assert_array_equal(qb.detach().numpy(), np.asarray(jb))
    gw, gb = torch.randn(qw.shape), torch.randn(qb.shape)
    torch.autograd.backward((qw, qb), (gw, gb))
    assert torch.equal(tw.grad, gw) and torch.equal(tb.grad, gb)
    jgw = jax.jit(jax.grad(lambda a: jnp.sum(jffn.fake_quantize(a, jnp.asarray(b))[0]
                                             * jnp.asarray(gw.numpy()))))(jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(jgw), gw.numpy())


def test_int8_refuses_grad_mode():
    """int8 weights train with grad mode on (ROADMAP A15, formerly
    refused here): the UNet (through RandomMoE) gives every FFN
    parameter a finite fp32 gradient, and both wrappers, given the
    full-precision weights with int8=(their int8 forms, their
    dequantized copies) as RandomMoE passes them, give the activations
    and the weights the gradients of the plain versions at the
    dequantized weights (straight-through). int8 weights given directly
    still refuse grad mode; with grad mode off the UNet and block_core
    run forward on them as before."""
    unet = UNet(UNetConfig(**INT8).tiny(), device="cpu",
                generator=torch.Generator().manual_seed(0))
    x, t = torch.randn(1, 8, 8, 8), torch.tensor([5], dtype=torch.int32)
    unet(x, t).square().mean().backward()
    ffn = [p for n, p in unet.named_parameters() if ".ffn." in n]
    assert ffn and all(p.grad is not None and p.grad.dtype == torch.float32
                       and torch.isfinite(p.grad).all() for p in ffn)
    assert unet.enc_stage_0.block_0.ffn.gwa.grad.abs().max() > 0
    full = [torch.from_numpy(a) for a in _ffn_weights(32, 32)]
    w = tffn.quantize_ffn(full)
    dq = tffn.dequantize_ffn(w, torch.float32)
    ids = torch.tensor((0, 1), dtype=torch.int32)
    rows = torch.randn(4, 32, requires_grad=True)
    ck, cb = torch.randn(3, 3, 32, 32), torch.randn(32)
    img = torch.randn(1, 2, 2, 32, requires_grad=True)
    for fn, args in ((tffn.ffn_block, (rows, rows, rows)),
                     (tbc.block_core, (img, img, img))):
        extra = (ck, cb) if fn is tbc.block_core else ()
        leaves = [t.detach().requires_grad_() for t in full]
        got = torch.autograd.grad(fn(*args, *leaves, *extra, ids, int8=(w, dq))[0].sum(),
                                  [args[0], *leaves])
        plain = tbc.block_core_plain if fn is tbc.block_core else tffn.ffn_block_plain
        at = [t.detach().requires_grad_() for t in dq]
        want = torch.autograd.grad(plain(*args, *at, *extra, ids)[0].sum(), [args[0], *at])
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, **TOL)
        with pytest.raises(ValueError, match="grad mode off only"):
            fn(*args, *w, *extra, ids)
    img = img.detach()
    with torch.no_grad():
        out = unet(x, t)
        got = tbc.block_core(img, img, img, *w, ck, cb, ids)
    assert out.shape == x.shape and torch.isfinite(out).all()
    want = tbc.block_core_plain(img, img, img, *w, ck, cb, ids)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_sample_cli_quant_int8_writes_images(tmp_path):
    from ldm_image_generator_tpu_torch.cli import sample_ldm

    sample_ldm.main(["--config", "tiny", "--quant", "int8", "-s", "16", "-n", "2",
                     "-t", "2", "-d", "cpu", "-o", str(tmp_path)])
    for i in range(2):
        data = (tmp_path / f"{i}.png").read_bytes()
        assert data.startswith(b"\x89PNG") and len(data) > 100


def test_pipeline_leaves_the_callers_modules_unchanged():
    """LDMPipeline(..., bfloat16) over fp32 modules and a sample leave
    every parameter's dtype and value as it was; the pipeline's cast
    copies and int8 weights are made once per weight version: a sample
    of unchanged weights quantizes nothing, and changed weights make
    them anew at the next sample."""
    gen = torch.Generator().manual_seed(0)
    unet = UNet(UNetConfig(**INT8).tiny(), device="cpu", generator=gen)
    decoder = Decoder(VAEConfig().tiny(), device="cpu", generator=gen)
    snap = lambda: {n: p.detach().clone() for m in (unet, decoder)
                    for n, p in m.named_parameters(prefix=type(m).__name__)}
    before = snap()
    q0 = tffn.quantizations
    pipe = LDMPipeline(unet, decoder, dtype=torch.bfloat16)
    made = tffn.quantizations - q0
    assert made == 6 * 2 * sum(UNetConfig().tiny().stages)  # 6 matrices a block
    noise = torch.randn((1, 8, 8, 8), generator=gen)
    img = pipe.sample(batch=1, image_size=IMAGE, num_steps=2, init_noise=noise)
    assert img.dtype == torch.uint8
    assert tffn.quantizations - q0 == made
    after = snap()
    assert all(after[n].dtype == torch.float32 and torch.equal(after[n], v)
               for n, v in before.items())
    assert pipe.unet is not unet and pipe.unet.dtype == torch.bfloat16
    with torch.no_grad():
        unet.dec_stage_0.block_0.ffn.gwa.mul_(0.5)  # new weights: a miss
    pipe.sample(batch=1, image_size=IMAGE, num_steps=2, init_noise=noise)
    assert tffn.quantizations - q0 == 2 * made
    assert unet.dec_stage_0.block_0.ffn.gwa.dtype == torch.float32


@pytest.mark.parametrize("field,value", [("ffn_backend", "xla"),
                                         ("attention_backend", "xla")])
def test_unet_refuses_config_fields_it_would_ignore(field, value):
    """Fields the port accepted and ignored raise until they are ported;
    the default config (which the trainers' CLIs build), int8, a
    class-conditional one and remat build."""
    with pytest.raises(NotImplementedError, match=field):
        UNet(dataclasses.replace(UNetConfig(), **{field: value}), device="meta")
    for cfg in (UNetConfig(), UNetConfig(ffn_quant="int8"), UNetConfig(num_classes=3),
                UNetConfig(remat=True),
                UNetConfig(ffn_backend="pallas", attention_backend="pallas")):
        UNet(cfg, device="meta")
