"""The port's img2img and inpainting against the JAX package's (tiny
config, CPU, fp32, routing pinned to experts (0, 1), v-prediction): DDIM
and DPM-Solver++ with per-sample CFG, inpainting with the projection
noise drawn along the JAX package's key chain, the mask resize against
jax.image.resize, the argument errors, and the sampling CLI's img2img and
mask flags."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import DDPMConfig as JDDPMConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.diffusion import ddim_sample as jddim
from ldm_image_generator_tpu.diffusion.ddpm import q_sample as jq_sample
from ldm_image_generator_tpu.diffusion.dpm_solver import dpm_solver_sample as jdpm
from ldm_image_generator_tpu.pipelines import LDMPipeline as JPipeline
from ldm_image_generator_tpu.pipelines import to_uint8 as jto_uint8
from ldm_image_generator_tpu_torch.cli import sample_ldm
from ldm_image_generator_tpu_torch.config import DDPMConfig, UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import flax_tree
from ldm_image_generator_tpu_torch.data.dataset import preprocess_image
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import Decoder, Encoder
from ldm_image_generator_tpu_torch.pipelines import (
    LDMPipeline,
    img2img_steps,
    resize_mask,
)

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-5)
IMAGE = 16   # tiny VAE downscale 2 -> 8x8 latent
LATENT = (8, 8, 8)
CLASSES = 3
FIXED = dict(fixed_expert_indices=(0, 1))
# v-prediction and a damped output layer keep the random UNet's latents
# O(1) over the steps (see tests/test_torch_port_cond.py)
DDPM = dict(prediction="v")
OUT_GAIN = 0.25


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, its UNet, Decoder and Encoder params, the port's
    pipeline on the same weights): the port's seeded weights handed to JAX
    through flax_tree, whose trees must have the JAX init's structure."""
    ucfg = UNetConfig(num_classes=CLASSES, **FIXED).tiny()
    vcfg = VAEConfig().tiny()
    gen = torch.Generator().manual_seed(5)
    unet = UNet(ucfg, device="cpu", generator=gen)
    decoder = Decoder(vcfg, device="cpu", generator=gen)
    encoder = Encoder(vcfg, device="cpu", generator=gen)
    with torch.no_grad():
        unet.decoder_last.kernel.mul_(OUT_GAIN)
    jp = JPipeline(JUNetConfig(num_classes=CLASSES, **FIXED).tiny(), JVAEConfig().tiny(),
                   JDDPMConfig(**DDPM), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1,) + LATENT)
    trees = [jax.tree.map(jnp.asarray, flax_tree(m)) for m in (unet, decoder, encoder)]
    inits = (lambda: jp.unet.init({"params": key, "moe": key}, z0, jnp.zeros((1,), jnp.int32)),
             lambda: jp.decoder.init(key, z0),
             lambda: jp.encoder.init(key, jnp.zeros((1, IMAGE, IMAGE, 3))))
    for tree, init in zip(trees, inits):
        want = jax.eval_shape(init)
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        assert jax.tree.map(jnp.shape, tree) == jax.tree.map(lambda a: a.shape, want)
    port = LDMPipeline(unet, decoder, DDPMConfig(**DDPM), dtype=torch.float32,
                       encoder=encoder)
    return (jp, *trees, port)


def images(batch: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -1, 1, size=(batch, IMAGE, IMAGE, 3)).astype(np.float32)


def normal(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def jax_img2img(jp, up, dp, ep, key, image, strength, num_steps, sampler="ddim",
                mask=None, fwd_noise=None, condition=None, guidance_scales=None,
                cfg_rescales=None, negative_condition=None):
    """(final latent, uint8 images) of the JAX package's img2img, as
    LDMPipeline._img2img_jit runs it, latent included."""
    T = jp.schedule.num_timesteps
    sub_steps = img2img_steps(T, strength, num_steps)
    as_j = lambda a: None if a is None else jnp.asarray(a)

    def run(up, dp, ep, key, image, mask, fwd_noise, cond, gs, phi, neg):
        z0 = jp.encoder.apply(ep, image).astype(jnp.float32)
        b, latent = z0.shape[0], z0.shape[1]
        key, k_fwd = jax.random.split(key)
        eps = (jax.random.normal(k_fwd, z0.shape, jnp.float32) if fwd_noise is None
               else fwd_noise)
        x_init = jq_sample(jp.schedule, z0, jnp.full((b,), sub_steps[-1], jnp.int32), eps)
        denoise, _, _ = jp._denoise_fn(
            up, latent, num_steps, sub_steps, True, cond, 1.0 if gs is None else gs,
            cfg_rescale=0.0 if phi is None else phi, negative_condition=neg)
        project_fn = None
        if mask is not None:
            m = jax.image.resize(mask, (b, latent, latent, 1), "linear")

            def project_fn(x, t_next, final, k):
                noise = jax.random.normal(k, z0.shape, jnp.float32)
                known = jq_sample(jp.schedule, z0, t_next, noise)
                return m * x + (1.0 - m) * jnp.where(final, z0, known)
        run_kw = dict(num_steps=num_steps, prediction=jp.prediction, init_noise=x_init,
                      steps=sub_steps)
        if sampler == "dpm++2m":
            z = jdpm(denoise, jp.schedule, key, z0.shape, **run_kw)
        else:
            z = jddim(denoise, jp.schedule, key, z0.shape, project_fn=project_fn, **run_kw)
        return z, jto_uint8(jp.decoder.apply(dp, z))

    z, img = jax.jit(run)(up, dp, ep, key, jnp.asarray(image), as_j(mask), as_j(fwd_noise),
                          as_j(condition), as_j(guidance_scales), as_j(cfg_rescales),
                          as_j(negative_condition))
    return np.asarray(z), np.asarray(img)


def projection_noise(key, shape, n_steps: int) -> np.ndarray:
    """The per-step inpainting noise of JAX's img2img with `key`: img2img
    splits (key, k_fwd), ddim_sample (key, init_key), then each scan step
    (k, k_noise, k_model) and (k, k_proj) and draws from k_proj."""
    key, _ = jax.random.split(key)
    k, _ = jax.random.split(key)
    draws = []
    for _ in range(n_steps):
        k, _, _ = jax.random.split(k, 3)
        k, k_proj = jax.random.split(k)
        draws.append(jax.random.normal(k_proj, shape, jnp.float32))
    return np.stack([np.asarray(d) for d in draws])


def assert_images_close(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("sampler,strength,num_steps", [
    ("ddim", 0.6, 5), ("dpm++2m", 0.6, 5), ("ddim", 1.0, 3), ("dpm++2m", 0.05, 4)])
def test_img2img_matches_jax(pipes, sampler, strength, num_steps):
    """img2img with injected forward noise and per-sample CFG (scales,
    rescales, a negative class): the final latent and the uint8 images,
    and the JAX helper's images equal to the JAX pipeline's own."""
    jp, up, dp, ep, tp = pipes
    img, fwd = images(3), normal((3,) + LATENT, 1)
    kw = dict(condition=np.array([0, 2, 1], np.int32),
              guidance_scales=np.array([1.0, 3.0, 5.0], np.float32),
              cfg_rescales=np.array([0.0, 0.7, 0.0], np.float32),
              negative_condition=np.array([CLASSES, 1, 0], np.int32))
    key = jax.random.PRNGKey(4)
    z_ref, img_ref = jax_img2img(jp, up, dp, ep, key, img, strength, num_steps, sampler,
                                 fwd_noise=fwd, **kw)
    img_jax = jp.img2img(up, dp, ep, key, jnp.asarray(img), strength=strength,
                         num_steps=num_steps, sampler=sampler, fwd_noise=jnp.asarray(fwd),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_array_equal(np.asarray(img_jax), img_ref)
    t = torch.from_numpy
    got, z = tp.img2img(t(img), strength=strength, num_steps=num_steps, sampler=sampler,
                        fwd_noise=t(fwd), return_latent=True,
                        **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert_images_close(got, img_ref)


@pytest.mark.parametrize("guided", [False, True])
def test_inpainting_matches_jax(pipes, guided):
    """A mask (one row all-keep, one half-and-half, one all-regenerate):
    the projection noise drawn along JAX's key chain and injected; the
    kept region's latent comes back as the encoded image's exactly."""
    jp, up, dp, ep, tp = pipes
    img, fwd = images(3, seed=2), normal((3,) + LATENT, 3)
    mask = np.zeros((3, IMAGE, IMAGE, 1), np.float32)
    mask[1, :, IMAGE // 2:] = 1.0
    mask[2] = 1.0
    kw = {}
    if guided:
        kw = dict(condition=np.array([1, 0, 2], np.int32),
                  guidance_scales=np.array([3.0, 2.0, 1.0], np.float32))
    key = jax.random.PRNGKey(7)
    strength, num_steps = 0.8, 5
    z_ref, img_ref = jax_img2img(jp, up, dp, ep, key, img, strength, num_steps,
                                 mask=mask, fwd_noise=fwd, **kw)
    img_jax = jp.img2img(up, dp, ep, key, jnp.asarray(img), strength=strength,
                         num_steps=num_steps, mask=jnp.asarray(mask),
                         fwd_noise=jnp.asarray(fwd), **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_array_equal(np.asarray(img_jax), img_ref)
    n_steps = len(img2img_steps(1000, strength, num_steps))
    proj = projection_noise(key, (3,) + LATENT, n_steps)
    t = torch.from_numpy
    got, z = tp.img2img(t(img), strength=strength, num_steps=num_steps, mask=t(mask),
                        fwd_noise=t(fwd), project_noise=t(proj), return_latent=True,
                        **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(z.numpy(), z_ref, **TOL)
    assert_images_close(got, img_ref)
    with torch.no_grad():
        z0 = tp.encoder(t(img[:1])).float()
    torch.testing.assert_close(z[0], z0[0], rtol=0, atol=0)


@pytest.mark.parametrize("src,latent", [(256, 32), (IMAGE, 8), (48, 6), (32, 4)])
def test_mask_resize_matches_jax(src, latent):
    """resize_mask against jax.image.resize(..., "linear") on random
    binary masks (antialiased shrinking)."""
    mask = (np.random.default_rng(src).uniform(size=(2, src, src, 1)) > 0.5
            ).astype(np.float32)
    want = jax.image.resize(jnp.asarray(mask), (2, latent, latent, 1), "linear")
    got = resize_mask(torch.from_numpy(mask), latent)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kwargs,match", [
    (dict(strength=0.0), r"strength must be in \(0, 1\]"),
    (dict(strength=1.5), r"strength must be in \(0, 1\]"),
    (dict(mask=torch.ones(1, IMAGE, IMAGE, 1), sampler="dpm++2m"), "requires sampler='ddim'"),
    (dict(condition=torch.tensor([0]), negative_condition=torch.tensor([1])),
     "no effect at guidance 1.0"),
    (dict(negative_condition=torch.tensor([1])), "requires a class-conditional"),
    (dict(sampler="euler"), "sampler"),
])
def test_img2img_refuses_bad_arguments(pipes, kwargs, match):
    """The JAX package's img2img errors (strength outside (0, 1], a mask
    with DPM-Solver++, a negative class at guidance 1), then the port's."""
    with pytest.raises(ValueError, match=match):
        pipes[-1].img2img(torch.zeros(1, IMAGE, IMAGE, 3), num_steps=2,
                          fwd_noise=torch.zeros((1,) + LATENT), **kwargs)


def test_img2img_needs_an_encoder(pipes):
    port = pipes[-1]
    pipe = LDMPipeline(port._src[0], port._src[1], DDPMConfig(**DDPM), dtype=torch.float32)
    with pytest.raises(ValueError, match="encoder"):
        pipe.img2img(torch.zeros(1, IMAGE, IMAGE, 3), num_steps=2)


def test_img2img_memoizes_the_encoder_cast(monkeypatch):
    """A bf16 pipeline casts the encoder once: a second img2img call of
    unchanged weights makes no cast copy."""
    from ldm_image_generator_tpu_torch import pipelines

    gen = torch.Generator().manual_seed(0)
    ucfg, vcfg = UNetConfig(**FIXED).tiny(), VAEConfig().tiny()
    pipe = LDMPipeline(UNet(ucfg, device="cpu", generator=gen),
                       Decoder(vcfg, device="cpu", generator=gen), dtype=torch.bfloat16,
                       encoder=Encoder(vcfg, device="cpu", generator=gen))
    casts = []
    cast = pipelines.cast_copy
    monkeypatch.setattr(pipelines, "cast_copy",
                        lambda m, d: casts.append(type(m).__name__) or cast(m, d))
    run = lambda: pipe.img2img(torch.zeros(1, IMAGE, IMAGE, 3), num_steps=2,
                               fwd_noise=torch.zeros((1,) + LATENT))
    first = run()
    assert torch.equal(run(), first) and casts == []
    assert pipe.encoder.dtype == torch.bfloat16
    with torch.no_grad():
        pipe._src[2].output_layer.bias.add_(0.5)
    run()
    assert casts == ["UNet", "Decoder", "Encoder"]


def test_preprocess_image_takes_a_file_object(tmp_path):
    """The server decodes uploads from memory: a file object gives the
    same array as its path."""
    import io

    from PIL import Image

    path = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (20, 12, 3), np.uint8)
                    ).save(path)
    want = preprocess_image(str(path), 16)
    np.testing.assert_array_equal(preprocess_image(io.BytesIO(path.read_bytes()), 16), want)


def test_sample_cli_img2img_and_mask(tmp_path, capsys, monkeypatch):
    """--init-image (tiled over -n) with -encp's encoder file, then with a
    --mask: the mask's black half keeps the init image's latent, so those
    pixels match the plain img2img run's less than the white half does."""
    from PIL import Image

    from ldm_image_generator_tpu_torch.convert import save_flax_file

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)).save("init.png")
    m = np.zeros((32, 32), np.uint8)
    m[:, 16:] = 255
    Image.fromarray(m).save("mask.png")
    save_flax_file(Encoder(VAEConfig().tiny(), device="cpu",
                           generator=torch.Generator().manual_seed(1)), "enc.msgpack")
    base = ["--config", "tiny", "-s", "32", "-n", "2", "-t", "4", "-d", "cpu",
            "--init-image", "init.png", "-encp", "enc.msgpack", "--strength", "0.5"]
    sample_ldm.main(base + ["-o", "plain"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint: enc.msgpack" in out and "saved 2 images" in out
    sample_ldm.main(base + ["--mask", "mask.png", "-o", "masked"])
    capsys.readouterr()
    read = lambda p: np.asarray(Image.open(p), np.int32)
    for i in range(2):
        plain, masked = read(f"plain/{i}.png"), read(f"masked/{i}.png")
        assert plain.shape == masked.shape == (32, 32, 3)
    init = read("init.png")
    keep = np.abs(read("masked/0.png") - init)[:, :12].mean()
    regen = np.abs(read("masked/0.png") - init)[:, 20:].mean()
    assert keep < regen
