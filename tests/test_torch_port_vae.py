"""The port's VAE training slice against the JAX package (CPU, fp32 unless
stated): the nearest-codebook search (plain version against the XLA
composition and the Pallas kernel in interpret mode), the quantizer's
loss and gradients, the discriminator and feature matching, vae_loss,
Adafactor against optax, two VAE train steps, the converters, the image
dataset and the trainer CLI."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldm_image_generator_tpu.config import DiscriminatorConfig as JDiscConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.data import dataset as jdataset
from ldm_image_generator_tpu.data.dataset import ImageDataset as JImageDataset
from ldm_image_generator_tpu.kernels.vq import (
    nearest_codebook_indices_pallas,
    nearest_codebook_indices_xla,
)
from ldm_image_generator_tpu.models import vae as jvae
from ldm_image_generator_tpu.train import steps as jsteps
from ldm_image_generator_tpu_torch.config import DiscriminatorConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import (
    decoder_from_flax,
    discriminator_from_flax,
    encoder_from_flax,
    flatten_tree,
    quantizer_from_flax,
)
from ldm_image_generator_tpu_torch.data.dataset import ImageDataset
from ldm_image_generator_tpu_torch.kernels import vq as tvq
from ldm_image_generator_tpu_torch.models import vae as tvae
from ldm_image_generator_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)

# fp32, sums in other orders (the port's other tests' tolerance)
TOL = dict(rtol=5e-4, atol=5e-5)
np_tree = lambda p: jax.tree.map(np.asarray, p)
TINY_DISC = dict(channels=(8, 8), stages=(1, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vq_plain_matches_xla_and_pallas(dtype):
    """N = 700 (not a multiple of the Pallas kernel's 512-row tile), K =
    256, D = 8; x rounded to the dtype the same way on both sides: the
    indices are equal, exactly."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(700, 8)).astype(np.float32)
    cb = rng.normal(size=(256, 8)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(nearest_codebook_indices_xla(jx, jnp.asarray(cb)))
    pallas = np.asarray(nearest_codebook_indices_pallas(jx, jnp.asarray(cb),
                                                        interpret=True))
    got = tvq.nearest_codebook_indices_plain(tx, torch.from_numpy(cb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(pallas, ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the wrapper takes [..., D] on the CPU through the plain version
    before = tvq.launches
    idx = tvq.nearest_codebook_indices(tx.reshape(7, 100, 8), torch.from_numpy(cb))
    assert tvq.launches == before and idx.shape == (7, 100)
    np.testing.assert_array_equal(idx.reshape(-1).numpy(), ref)


def test_vq_first_index_on_ties():
    """A codebook of two equal halves: every vector's nearest code is in
    both, and the first (lower half) wins, as in the JAX package."""
    rng = np.random.default_rng(1)
    half = rng.normal(size=(128, 8)).astype(np.float32)
    cb = np.concatenate([half, half])
    x = rng.normal(size=(300, 8)).astype(np.float32)
    got = tvq.nearest_codebook_indices(torch.from_numpy(x), torch.from_numpy(cb))
    ref = np.asarray(nearest_codebook_indices_xla(jnp.asarray(x), jnp.asarray(cb)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got < 128).all()
    np.testing.assert_array_equal(
        got.numpy(), tvq.nearest_codebook_indices(torch.from_numpy(x),
                                                  torch.from_numpy(half)).numpy())


def test_vq_mismatch_rule_names_only_near_ties():
    from ldm_image_generator_tpu_torch.kernels.workloads import VQ_TIE_REL, vq_mismatches

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    want = tvq.nearest_codebook_indices_plain(x, cb)
    assert vq_mismatches(x, cb, want, want) == (0, 0.0)
    wrong = want.clone()
    wrong[3] = (wrong[3] + 1) % 64
    n, gap = vq_mismatches(x, cb, wrong, want)
    assert n == 1 and gap > VQ_TIE_REL
    cb2 = torch.cat([cb, cb[want[:1].long()]])  # row 64 ties row want[0]
    n, gap = vq_mismatches(x, cb2, torch.cat([torch.tensor([64], dtype=torch.int32),
                                              want[1:]]), want)
    assert n == 1 and gap == 0.0


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32):
    the 13 low mantissa bits rounded into the rest of the magnitude."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_toward_zero(d: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 truncated toward zero (the tensor cores'
    accumulator does not round to nearest)."""
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core_vq(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The vq kernel's arithmetic in plain PyTorch (csrc/vq.cu): -2e and x
    split into TF32 heads and tails, the accumulator started at ||e||^2
    rounded once from float64, then one m16n8k8 product per pass, head *
    head, head * tail, tail * head (no tail for a bf16 x), each pass's
    eight products summed exactly and the result truncated to fp32; the
    first index of the minimum. Only codes whose fp32 score lies within
    2**-10 of the row's scale of its minimum are emulated: either
    arithmetic's error is below 2**-18 of it."""
    xf, e = x.float(), codebook.float()
    q = (codebook.double() ** 2).sum(-1).float()
    approx = q[None] - 2.0 * (xf @ e.T)
    scale = q.max() + 2.0 * xf.abs().sum(1, keepdim=True) * e.abs().max()
    rows, codes = torch.nonzero(
        approx <= approx.min(1, keepdim=True).values + 2.0 ** -10 * scale, as_tuple=True)
    m = -2.0 * e[codes]
    bh = _tf32(m)
    a = xf[rows]
    ah = _tf32(a)
    passes = [(ah, bh), (ah, _tf32(m - bh))]
    if x.dtype == torch.float32:
        passes.append((_tf32(a - ah), bh))
    acc = q[codes]
    for pa, pb in passes:
        acc = _round_toward_zero(acc.double() + (pa.double() * pb.double()).sum(-1))
    n = x.shape[0]
    best = torch.full((n,), float("inf")).scatter_reduce(0, rows, acc, "amin")
    hit = acc == best[rows]
    first = torch.full((n,), e.shape[0]).scatter_reduce(0, rows[hit], codes[hit], "amin")
    return first.int()


@pytest.mark.parametrize("codebook", ["random", "near_tie"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vq_tensor_core_split_stays_within_the_tie_rule(dtype, codebook):
    """The kernel's TF32 split (emulated) at the VAE step's shape, 4608
    latents against K = 8192: its indices equal XLA's except where the
    two codes' exact scores lie within VQ_TIE_REL of their magnitude. The
    near-tie codebook holds pairs 2**-18 apart and exact duplicates K/2
    on (workloads.near_tie_codebook)."""
    from ldm_image_generator_tpu_torch.kernels.workloads import (
        VQ_TIE_REL,
        near_tie_codebook,
        vae_train_calls,
        vq_mismatches,
    )

    (call,) = vae_train_calls()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(call.n, call.c)).astype(np.float32)
    if codebook == "random":
        cb = torch.from_numpy(rng.normal(size=(call.l, call.c)).astype(np.float32))
    else:
        cb = near_tie_codebook(call.l, call.c, torch.Generator().manual_seed(3), "cpu")
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = nearest_codebook_indices_xla(jnp.asarray(x).astype(dtype), jnp.asarray(cb.numpy()))
    got = _tensor_core_vq(tx, cb)
    n, gap = vq_mismatches(tx, cb, got, torch.from_numpy(np.array(ref)))
    assert gap <= VQ_TIE_REL, (n, gap)
    if codebook == "near_tie":
        # exact duplicates: never the second copy
        assert (got < call.l // 2).all()


@pytest.mark.parametrize("dtype,ms", [(torch.float32, 0.00366), (torch.bfloat16, 0.00183)])
def test_vq_bound_counts_the_tf32_passes_of_each_dtype(dtype, ms):
    """The vq bound at the VAE step: the least-cost fp32-accurate passes
    of 2 N K D on the tensor cores, three TF32 passes at 495 TFLOP/s for
    an fp32 x (0.00366 ms), three bf16 passes at 989 TFLOP/s for a bf16
    x, exact in bf16, against the codebook split in three bf16 pieces
    (0.00183 ms; two TF32 passes would take 0.00244), above the score and
    compare at 67 TFLOP/s and the bytes (x once, the fp32 codebook once,
    int32 indices out)."""
    from ldm_image_generator_tpu_torch.kernels.workloads import bound_ms, vae_train_calls, work

    (call,) = vae_train_calls()
    got, by = bound_ms(call, dtype)
    assert by == "operations" and got == pytest.approx(ms, abs=5e-6)
    nbytes, ops = work(call, dtype)
    x_bytes = {torch.float32: 4, torch.bfloat16: 2}[dtype] * 4608 * 8
    assert nbytes == x_bytes + 4 * 8192 * 8 + 4 * 4608
    unit, passes = {torch.float32: ("tf32", 3), torch.bfloat16: (torch.bfloat16, 3)}[dtype]
    assert ops == {unit: passes * 2 * 4608 * 8192 * 8, torch.float32: 2 * 4608 * 8192}


@pytest.mark.parametrize("layout", ["halves", "next_rank", "mid", "quad", "pair"])
def test_tie_codebook_places_each_copy_as_named(layout):
    """The card tests' exact-duplicate layouts: each copy equals its first
    copy and lies after it (K/2 on for halves, one slice on for next_rank,
    half a slice's tiles on in the same slice for mid, 4 on in the same
    8-code tile for quad, 1 on in the same pair for pair); the plain
    version never returns a second copy."""
    from ldm_image_generator_tpu_torch.kernels.workloads import tie_codebook

    cb, copy_of = tie_codebook(300, 8, layout, torch.Generator().manual_seed(4), "cpu",
                               slice_codes=40)
    second = torch.nonzero(copy_of != torch.arange(300)).flatten()
    first = copy_of[second]
    assert second.numel() >= 100 and torch.equal(cb[second], cb[first])
    assert (copy_of[first] == first).all()
    step = {"halves": 150, "next_rank": 40, "mid": 24, "quad": 4, "pair": 1}[layout]
    assert ((second - first) == step).all()
    if layout == "next_rank":
        assert ((second // 40) == (first // 40) + 1).all()
    if layout == "mid":  # 5 tiles a slice: tiles 0-2, then 3-4
        assert ((second // 40) == (first // 40)).all()
        assert (first % 40 < 24).all() and (second % 40 >= 24).all()
    if layout == "quad":
        assert ((second // 8) == (first // 8)).all()
    if layout == "pair":
        assert ((second // 2) == (first // 2)).all()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2000, 8)).astype(np.float32))
    got = tvq.nearest_codebook_indices(x, cb).long()
    assert torch.equal(copy_of[got], got)
    assert torch.isin(got, second).sum() == 0 and torch.isin(got, first).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_loss_and_grads_match_jax(dtype):
    """The symmetric L1 commitment loss and its gradients with respect to
    the latents and the codebook (which reach only the selected rows). A
    bf16 x meets the fp32 codes in fp32 on both sides."""
    jq = jvae.VectorQuantizer(64, 8)
    x = np.random.default_rng(3).normal(size=(2, 50, 8)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    params = jq.init(jax.random.PRNGKey(0), jx)
    loss, (gp, gx) = jax.value_and_grad(lambda p, v: jq.apply(p, v), (0, 1))(params, jx)
    port = quantizer_from_flax(np_tree(params), JVAEConfig().tiny(), device="cpu")
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    got = port(tx)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-6)
    ge = port.embeddings.grad.numpy()
    np.testing.assert_allclose(ge, np.asarray(gp["params"]["embeddings"]),
                               rtol=1e-6, atol=1e-9)
    idx = port.quantize(tx).reshape(-1).long()
    assert (np.abs(ge).sum(1)[np.setdiff1d(np.arange(64), idx.numpy())] == 0).all()
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(gx.astype(jnp.float32)), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("stem", [1, 2])
def test_discriminator_and_feature_matching_match_jax(stem):
    jcfg = JDiscConfig(stem_size=stem, **TINY_DISC)
    jd = jvae.Discriminator(jcfg)
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    params = jd.init(jax.random.PRNGKey(1), jnp.asarray(real))
    ref_logit, ref_feats = jd.apply(params, jnp.asarray(real), features=True)
    ref_fake = jd.apply(params, jnp.asarray(fake), features=True)[1]
    ref_fm = jvae.feature_matching_loss(ref_fake, ref_feats)
    port = discriminator_from_flax(np_tree(params),
                                   DiscriminatorConfig(stem_size=stem, **TINY_DISC),
                                   device="cpu")
    logit, feats = port(torch.from_numpy(real), features=True)
    np.testing.assert_allclose(logit.item(), float(ref_logit), **TOL)
    assert len(feats) == len(ref_feats) == 2
    for f, r in zip(feats, ref_feats):
        assert f.shape == r.shape
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(port(torch.from_numpy(real)).item(), float(ref_logit), **TOL)
    fm = tvae.feature_matching_loss(port(torch.from_numpy(fake), features=True)[1], feats)
    np.testing.assert_allclose(fm.item(), float(ref_fm), **TOL)


def _tiny_vae(key=0, size=16):
    """JAX tiny encoder, decoder and quantizer with their params."""
    cfg = JVAEConfig().tiny()
    enc, dec = jvae.Encoder(cfg), jvae.Decoder(cfg)
    q = jvae.VectorQuantizer(cfg.num_embeddings, cfg.embedding_dim)
    k = jax.random.PRNGKey(key)
    side = size // cfg.downscale
    z0 = jnp.zeros((1, side, side, cfg.latent_channels))
    params = {"encoder": enc.init(k, jnp.zeros((1, size, size, 3)))["params"],
              "decoder": dec.init(k, z0)["params"],
              "quantizer": q.init(k, z0.reshape(1, -1, cfg.latent_channels))["params"]}
    return cfg, (enc, dec, q), params


def _port_vae(params):
    cfg = VAEConfig().tiny()
    return torch.nn.ModuleDict({
        "encoder": encoder_from_flax(np_tree(params["encoder"]), cfg, device="cpu"),
        "decoder": decoder_from_flax(np_tree(params["decoder"]), cfg, device="cpu"),
        "quantizer": quantizer_from_flax(np_tree(params["quantizer"]), cfg, device="cpu")})


def test_vae_loss_matches_jax():
    """vae_loss with the noise JAX drew injected; the VAE wrapper (and its
    calclate_loss spelling) gives the same."""
    cfg, (enc, dec, q), params = _tiny_vae()
    x = np.random.default_rng(5).uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    recon, reg, y = jvae.vae_loss(
        lambda v: enc.apply({"params": params["encoder"]}, v),
        lambda v: dec.apply({"params": params["decoder"]}, v),
        lambda v: q.apply({"params": params["quantizer"]}, v),
        jnp.asarray(x), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, 8, 8, 8))))
    vae = _port_vae(params)
    wrapper = tvae.VAE(vae["encoder"], vae["decoder"], vae["quantizer"])
    for fn in (wrapper.calculate_loss, wrapper.calclate_loss):
        t_recon, t_reg, t_y = fn(torch.from_numpy(x), noise=noise)
        np.testing.assert_allclose(t_recon.item(), float(recon), **TOL)
        np.testing.assert_allclose(t_reg.item(), float(reg), **TOL)
        np.testing.assert_allclose(t_y.detach().numpy(), np.asarray(y), **TOL)
    z = wrapper.encode(torch.from_numpy(x))
    assert z.shape == (2, 8, 8, 8) and wrapper.decode(z).shape == (2, 16, 16, 3)


def test_encoder_and_decoder_take_a_compute_dtype():
    """dtype= at call time computes in bf16 over fp32 parameters (the
    gradient reaches them in fp32); the default stays the parameters'."""
    cfg = VAEConfig().tiny()
    gen = torch.Generator().manual_seed(0)
    enc = tvae.Encoder(cfg, device="cpu", generator=gen)
    dec = tvae.Decoder(cfg, device="cpu", generator=gen)
    x = torch.rand(1, 16, 16, 3) * 2 - 1
    assert enc(x).dtype == torch.float32
    z = enc(x, dtype=torch.bfloat16)
    y = dec(z, dtype=torch.bfloat16)
    assert z.dtype == y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert enc.input_layer.kernel.grad.dtype == torch.float32
    torch.testing.assert_close(y.float(), dec(enc(x)).detach(), rtol=0.1, atol=0.1)


ADAFACTOR_SHAPES = [(3, 3, 128, 128), (3, 3, 64, 64), (8192, 8), (128, 256),
                    (128,), (256,), (64,)]


def test_factored_dims_follow_argsort():
    """np.argsort's two largest axes, factored only when the second is >=
    128: HWIO [3,3,128,128] factors axes (2, 3); [3,3,64,64], [8192, 8],
    1-D tensors and every default discriminator tensor do not."""
    dims = [tsteps.factored_dims(s) for s in ADAFACTOR_SHAPES]
    assert dims == [(2, 3), None, None, (0, 1), None, None, None]
    assert tsteps.factored_dims((2, 2, 512, 256)) == (3, 2)
    disc = tvae.Discriminator(DiscriminatorConfig(), device="meta")
    assert all(tsteps.factored_dims(tuple(p.shape)) is None for p in disc.parameters())


@pytest.mark.parametrize("kw", [dict(), dict(grad_clip=0.5), dict(accumulate=2)],
                         ids=["adafactor", "clip", "multisteps"])
def test_adafactor_matches_optax(kw):
    """Seven steps of make_optimizer('adafactor') against the JAX package's
    (optax.adafactor with the relative step), at the AdamW test's
    tolerance: params, and the factored and full second moments. The
    biases start at zero (the 1e-3 floor of the parameter scale) and one
    never gets a gradient."""
    rng = np.random.default_rng(6)
    params = [(rng.normal(size=s) * (0.05 if len(s) > 1 else 0.0)).astype(np.float32)
              for s in ADAFACTOR_SHAPES]
    jtx = jsteps.make_optimizer("adafactor", **kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    ttx = tsteps.make_optimizer("adafactor", **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tp)
    for _ in range(7):
        g = [(rng.normal(size=s) * 0.1).astype(np.float32) for s in ADAFACTOR_SHAPES]
        g[-1][...] = 0.0
        upd, jstate = jtx.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = ttx.apply(tp, [torch.from_numpy(a) for a in g], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    inner_t = tstate.inner_opt_state if "accumulate" in kw else tstate
    factored = _find_state(jstate, "v_row")
    assert inner_t.count == int(factored.count)
    # the second moments are means over up to 384 squares, summed in
    # another order than XLA's: rtol 1e-5
    for name in ("v_row", "v_col", "v"):
        for a, b in zip(getattr(inner_t, name), getattr(factored, name)):
            if a is not None:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-30)


def _find_state(tree, field):
    """The first state in an optax state tree that has `field`."""
    if hasattr(tree, field):
        return tree
    if isinstance(tree, tuple):
        for t in tree:
            found = _find_state(t, field)
            if found is not None:
                return found
    return getattr(tree, "inner_opt_state", None) and _find_state(
        tree.inner_opt_state, field)


def test_relative_step_matches_jax():
    """min(1e-2, rsqrt(count + 1)) in float32: equal where the min holds
    (up to count 9999, where rsqrt(10000) rounds to the same float32 as
    1e-2); beyond, within one float32 ulp of XLA's CPU rsqrt (the port's
    is correctly rounded)."""
    jfn = lambda c: float(jnp.minimum(1e-2, jax.lax.rsqrt(jnp.int32(c) + 1.0)))
    for count in (0, 9998, 9999):
        assert tsteps.relative_step(count) == jfn(count) == np.float32(1e-2)
    for count in (10000, 10 ** 6):
        assert tsteps.relative_step(count) < np.float32(1e-2)
        np.testing.assert_allclose(tsteps.relative_step(count), jfn(count), rtol=1e-6)


def _jax_crop_and_noise(key, images_shape, crop, z_shape):
    """The crop offset and the latent noise JAX's VAE step draws from key."""
    k_crop, k_noise = jax.random.split(key)
    ky, kx = jax.random.split(k_crop)
    top = int(jax.random.randint(ky, (), 0, images_shape[1] - crop + 1))
    left = int(jax.random.randint(kx, (), 0, images_shape[2] - crop + 1))
    noise = np.array(jax.random.normal(k_noise, z_shape))
    return (top, left), torch.from_numpy(noise)


def test_random_crop_batch_matches_jax():
    images = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    for i in range(4):
        key = jax.random.PRNGKey(i)
        ref = np.asarray(jsteps.random_crop_batch(jnp.asarray(images), 16, key))
        ky, kx = jax.random.split(key)
        offset = (int(jax.random.randint(ky, (), 0, 17)),
                  int(jax.random.randint(kx, (), 0, 17)))
        got = tsteps.random_crop_batch(torch.from_numpy(images), 16, offset=offset)
        np.testing.assert_array_equal(got.numpy(), ref)
    a = tsteps.random_crop_batch(torch.from_numpy(images), 16,
                                 torch.Generator().manual_seed(3))
    b = tsteps.random_crop_batch(torch.from_numpy(images), 16,
                                 torch.Generator().manual_seed(3))
    assert a.shape == (2, 16, 16, 3) and torch.equal(a, b)


VAE_STEPS = 2


def test_two_vae_train_steps_match_jax():
    """make_vae_train_step at the tiny configs, 32px images cropped to 16,
    Adafactor on both nets, fp32: for two steps the crop offsets and the
    latent noise are the ones JAX's step draws from its key, and after
    each step the five metrics and every parameter of both nets match the
    JAX step's."""
    cfg, (enc, dec, q), vae_params = _tiny_vae(key=0)
    jd = jvae.Discriminator(JDiscConfig(**TINY_DISC))
    disc_params = jd.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]
    jtx_v, jtx_d = jsteps.make_optimizer("adafactor"), jsteps.make_optimizer("adafactor")
    jstate = jsteps.VAETrainState(
        vae_params=vae_params, disc_params=disc_params,
        opt_state_vae=jtx_v.init(vae_params), opt_state_disc=jtx_d.init(disc_params),
        step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jsteps.make_vae_train_step(enc, dec, q, jd, jtx_v, jtx_d,
                                               crop_size=16))

    vae = _port_vae(vae_params)
    disc = discriminator_from_flax(np_tree(disc_params),
                                   DiscriminatorConfig(**TINY_DISC), device="cpu")
    ttx_v, ttx_d = tsteps.make_optimizer("adafactor"), tsteps.make_optimizer("adafactor")
    tstate = tsteps.VAETrainState(
        vae_params=vae, disc_params=disc,
        opt_state_vae=ttx_v.init(list(vae.parameters())),
        opt_state_disc=ttx_d.init(list(disc.parameters())))
    tstep = tsteps.make_vae_train_step(vae["encoder"], vae["decoder"], vae["quantizer"],
                                       disc, ttx_v, ttx_d, crop_size=16)
    images = np.random.default_rng(9).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float16)
    for i in range(VAE_STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(11), i)
        offset, noise = _jax_crop_and_noise(key, images.shape, 16, (2, 8, 8, 8))
        jstate, jm, (jy, jcrop) = jstep(jstate, jnp.asarray(images), key)
        tstate, tm, (ty, tcrop) = tstep(tstate, torch.from_numpy(images),
                                        crop_offset=offset, noise=noise)
        assert tstate.step == int(jstate.step) == i + 1
        np.testing.assert_array_equal(tcrop.numpy(), np.asarray(jcrop))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        assert set(tm) == set(jm) == {"loss", "recon", "reg", "adv", "d_loss"}
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), err_msg=k, **TOL)
        for mod, ref in (*((vae[n], jstate.vae_params[n]) for n in vae),
                         (disc, jstate.disc_params)):
            want = flatten_tree(np_tree(ref))
            got = dict(mod.named_parameters())
            assert set(got) == set(want)
            for n, p in got.items():
                assert p.grad is not None, n
                np.testing.assert_allclose(p.detach().numpy(), want[n],
                                           err_msg=f"step {i} {n}", **TOL)


@pytest.mark.parametrize("what", ["quantizer", "discriminator"])
def test_converters_round_trip_and_raise_on_a_wrong_name(what):
    if what == "quantizer":
        mod = jvae.VectorQuantizer(64, 8)
        params = mod.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 8)))
        conv = lambda tree: quantizer_from_flax(tree, VAEConfig().tiny(), device="cpu")
    else:
        mod = jvae.Discriminator(JDiscConfig(**TINY_DISC))
        params = mod.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)))
        conv = lambda tree: discriminator_from_flax(tree, DiscriminatorConfig(**TINY_DISC),
                                                    device="cpu")
    tree = np_tree(params)
    port = conv(tree)
    flat = flatten_tree(tree["params"])
    state = port.state_dict()
    assert set(state) == set(flat)
    for n, v in flat.items():
        np.testing.assert_array_equal(state[n].numpy(), v)
    bad = dict(tree["params"])
    first = sorted(bad)[0]
    bad[first + "_renamed"] = bad.pop(first)
    with pytest.raises(KeyError):
        conv({"params": bad})


def _images(tmp_path, n=4, size=32):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size + 8, 3), dtype=np.uint8)).save(
            d / f"{i}.png")
    return str(d)


def test_image_dataset_matches_jax(tmp_path):
    """The same files in the same order as the JAX ImageDataset, each
    preprocessed as the JAX package's dataset does (a non-square source,
    downscaled: resize, blur, pad; both packages' native decoder where it
    builds, else PIL), held as float16 in the cache and served as float32,
    as the JAX dataset serves it; where neither decoder is built, equal to
    the JAX package's PIL path."""
    from ldm_image_generator_tpu.data import native_loader as jnative
    from ldm_image_generator_tpu_torch.data import native_loader

    imgs = _images(tmp_path)
    ref = JImageDataset([imgs], cache_dir=str(tmp_path / "cache"), size=24, max_len=3)
    got = ImageDataset([imgs], cache_dir=str(tmp_path / "port_cache"), size=24, max_len=3)
    assert len(got) == len(ref) == 3 and got.paths == ref.paths
    native = native_loader.available() and jnative.available()
    for i, path in enumerate(ref.paths):
        want = (ref[i] if native else
                jdataset.preprocess_image(path, 24, use_native=False).astype(np.float16))
        assert got[i].dtype == np.float32 and got[i].shape == (24, 24, 3)
        np.testing.assert_array_equal(got[i], np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="no .jpg/.png"):
        ImageDataset([str(tmp_path / "cache")])


def test_train_vae_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    from ldm_image_generator_tpu_torch.cli import train_vae

    monkeypatch.chdir(tmp_path)
    imgs = _images(tmp_path)
    state = train_vae.main([imgs, "--config", "tiny", "-d", "cpu", "-s", "32",
                            "-b", "2", "-e", "5", "-r", "out", "--save-every", "1"])
    out = capsys.readouterr().out
    assert "dataset: 4 images at 32px" in out
    assert "saved ./vae_encoder.pt, ./vae_decoder.pt, vae_quantizer.pt, " \
           "./discriminator.pt" in out
    for name in ("vae_encoder.pt", "vae_decoder.pt", "vae_quantizer.pt",
                 "discriminator.pt"):
        assert (tmp_path / name).stat().st_size > 0
    # the JSON metric lines come every 10 steps
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [r["step"] for r in records] == [10] and state.step == 10
    metrics = {k: v for k, v in records[0].items()
               if k not in ("step", "time", "steps_per_s", "images_per_s")}
    assert set(metrics) == {"loss", "recon", "reg", "adv", "d_loss"}
    assert np.isfinite(list(metrics.values())).all()
    for i in range(2):
        for name in ("reconstructed", "input"):
            assert (tmp_path / "out" / f"{i}_{name}.jpg").stat().st_size > 0
    for mod in (state.vae_params, state.disc_params):
        assert all(torch.isfinite(p).all() for p in mod.parameters())


@pytest.mark.parametrize("flags,item", [
    (["-ep", "enc.pt"], "A12"),
    (["-dp", "enc.pt"], "A12"), (["-qp", "enc.pt"], "A12"),
    (["-discp", "enc.pt"], "A12")])
def test_train_vae_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, flags, item):
    """A reference (torch) state_dict file for any of the four models,
    which the trainer refused until ROADMAP `item` ported the converters:
    made by the JAX package's torch_export from seeded weights, it loads
    through the CLI, and the model starts from exactly those weights."""
    from ldm_image_generator_tpu.utils import torch_export as jte
    from ldm_image_generator_tpu_torch.cli import train_vae
    from ldm_image_generator_tpu_torch.convert import flax_tree

    monkeypatch.chdir(tmp_path)
    cfg, dcfg = VAEConfig().tiny(), DiscriminatorConfig(**TINY_DISC)
    gen = torch.Generator().manual_seed(7)
    module, export = {
        "-ep": (lambda: tvae.Encoder(cfg, device="cpu", generator=gen),
                lambda t: jte.export_encoder(t, JVAEConfig().tiny())),
        "-dp": (lambda: tvae.Decoder(cfg, device="cpu", generator=gen),
                lambda t: jte.export_decoder(t, JVAEConfig().tiny())),
        "-qp": (lambda: tvae.VectorQuantizer(cfg.num_embeddings, cfg.embedding_dim,
                                             device="cpu", generator=gen),
                jte.export_quantizer),
        "-discp": (lambda: tvae.Discriminator(dcfg, device="cpu", generator=gen),
                   lambda t: jte.export_discriminator(t, JDiscConfig(**TINY_DISC))),
    }[flags[0]]
    want = module()
    jte.save_state_dict(str(tmp_path / flags[1]), export(flax_tree(want)))
    with open(tmp_path / flags[1], "rb") as f:
        assert f.read(2) == b"PK"
    state = train_vae.main([_images(tmp_path), "-d", "cpu", "--config", "tiny",
                            "-s", "32", "-b", "2", "-e", "0", "-r", "out", *flags])
    got = {"-ep": lambda: state.vae_params["encoder"],
           "-dp": lambda: state.vae_params["decoder"],
           "-qp": lambda: state.vae_params["quantizer"],
           "-discp": lambda: state.disc_params}[flags[0]]()
    sw, sg = want.state_dict(), got.state_dict()
    assert sw.keys() == sg.keys()
    for name in sw:
        assert torch.equal(sg[name], sw[name]), name


def test_cuda_request_without_card_raises_in_vae_trainer(tmp_path, monkeypatch):
    from ldm_image_generator_tpu_torch.cli import train_vae

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        train_vae.main([_images(tmp_path), "--config", "tiny", "-s", "32"])


def test_make_optimizer_refuses_radam_naming_the_roadmap():
    """radam is ported (the pixel DDPM's optimizer, with MultiSteps and
    clipping as the others); an unknown name raises."""
    tx = tsteps.make_optimizer("radam", grad_clip=1.0, accumulate=2)
    assert isinstance(tx, tsteps.MultiSteps) and isinstance(tx.inner, tsteps.RAdam)
    assert tx.inner.grad_clip == 1.0
    with pytest.raises(ValueError, match="unknown optimizer 'sgd'"):
        tsteps.make_optimizer("sgd")
    assert isinstance(tsteps.make_optimizer("adafactor"), tsteps.Adafactor)
    assert dataclasses.is_dataclass(tsteps.VAETrainState)
