"""The port's DiT (models/dit.py) on the pipeline's normal path, against
the plain float32 reference (reference_torch/dit.py) on seeded random
weights at DiTConfig.tiny() (depth 2, hidden 64, 4 heads of 16, patch 2,
an 8x8x4 latent, 10 classes), on the CPU: the forward, the published
parameter count and names, a guided DDIM sample, SamplerServer against
the pipeline, DeepCache's refusal, the spans and the sampling CLI."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from ldm_image_generator_tpu_torch.cli import sample_ldm
from ldm_image_generator_tpu_torch.cli.serve import make_variants
from ldm_image_generator_tpu_torch.config import DDPMConfig, DiTConfig, VAEConfig
from ldm_image_generator_tpu_torch.models.dit import DiT
from ldm_image_generator_tpu_torch.models.vae import Decoder, Encoder
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
from ldm_image_generator_tpu_torch.serving import SamplerServer
from ldm_image_generator_tpu_torch.utils import profiling
from reference_torch import dit as ref

torch.set_num_threads(1)
CFG = DiTConfig().tiny()
RCFG = dataclasses.asdict(CFG)
VAE = dataclasses.replace(VAEConfig().tiny(), latent_channels=4, embedding_dim=4)
SIZE = 16  # the tiny VAE's downscale 2: an 8x8 latent
WAIT = 60  # seconds any single wait may take
# fp32 on both sides; the two differ only in the order of their sums
# (F.linear, SDPA and F.layer_norm against matmul, softmax and a mean):
# a forward agrees to ~1e-6
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# four DDIM steps: x0 = (x - sqrt(1 - ab) eps) / sqrt(ab) scales a step's
# eps gap by up to 1 / sqrt(ab_999) ~ 156 before the last steps shrink it
SAMPLE_TOL = dict(rtol=1e-4, atol=1e-4)


def random_params(seed: int = 0) -> dict:
    """{name: tensor} under DiT's names: kernels at lecun scale, biases
    N(0, 0.02), the class table N(0, 1/D) (nothing zero, unlike DiT's
    init, so every block computes)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, fan) in ref.shapes(RCFG).items():
        std = 0.02 if fan is None else shape[-1] ** -0.5 if fan == "embed" else fan ** -0.5
        out[name] = torch.randn(shape, generator=g) * std
    return out


@pytest.fixture(scope="module")
def weights():
    return random_params()


def port_dit(P: dict) -> DiT:
    dit = DiT(CFG, device="cpu")
    dit.load_state_dict(dict(P, pos_embed=dit.pos_embed), strict=True)
    return dit


@pytest.fixture(scope="module")
def pipe(weights):
    dec = Decoder(VAE, device="cpu", generator=torch.Generator().manual_seed(1))
    enc = Encoder(VAE, device="cpu", generator=torch.Generator().manual_seed(2))
    return LDMPipeline(port_dit(weights), dec, DDPMConfig(), dtype=torch.float32, encoder=enc)


@pytest.mark.parametrize("t", [0, 517, 999])
def test_forward_matches_reference(weights, t):
    g = torch.Generator().manual_seed(t)
    x = torch.randn(4, 8, 8, 4, generator=g)
    y = torch.tensor([0, 3, 9, CFG.num_classes])  # the last row: the null class
    with torch.no_grad():
        got = port_dit(weights)(x, torch.tensor([t], dtype=torch.int32), y)
        want = ref.forward(weights, RCFG, x, torch.tensor([t]), y)
    assert got.shape == (4, 8, 8, CFG.out_channels)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)
    # condition None is the null class for every row
    with torch.no_grad():
        null = port_dit(weights)(x, torch.tensor([t]), None)
    np.testing.assert_allclose(null[3].numpy(), got[3].numpy(), rtol=0, atol=0)


def test_xl_2_has_the_published_parameters_and_names():
    dit = DiT(DiTConfig.xl_2(), device="meta")
    sizes = {n: p.numel() for n, p in dit.named_parameters()}
    assert sum(v for n, v in sizes.items() if n != "pos_embed") == 674_834_720
    assert sizes["pos_embed"] == 1_179_648  # 1,024 tokens at a 64x64 latent
    # at 256px (32x32, 256 tokens): DiT's train.py prints 675,129,632
    assert sum(p.numel() for p in DiT(DiTConfig.xl_2(32), device="meta").parameters()) \
        == 675_129_632
    want = ref.shapes(dataclasses.asdict(DiTConfig.xl_2()))
    got = {n: tuple(t.shape) for n, t in dit.state_dict().items() if n != "pos_embed"}
    assert got == {n: s for n, (s, _) in want.items()}
    assert not dit.pos_embed.requires_grad and dit.pos_embed.shape == (1, 1024, 1152)
    assert dit.blocks[0].mlp.fc1.weight.shape == (4608, 1152)  # 16 heads of 72, MLP 4608


@pytest.mark.parametrize("guidance", [1.0, 1.5])
def test_pipeline_ddim_sample_matches_reference(weights, pipe, guidance):
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(3, 8, 8, 4, generator=g)
    classes = torch.tensor([1, 7, 4])
    _, z = pipe.sample(None, batch=3, image_size=SIZE, num_steps=4, init_noise=noise,
                       condition=classes, guidance_scale=guidance, return_latent=True)
    want = ref.sample(weights, RCFG, noise, classes, guidance, 4, ref.alpha_bar())
    np.testing.assert_allclose(z.numpy(), want.numpy(), **SAMPLE_TOL)


def test_dpm_solver_and_img2img_run_the_dit(pipe):
    g = torch.Generator().manual_seed(4)
    imgs = pipe.sample(g, batch=2, image_size=SIZE, num_steps=3, sampler="dpm++2m",
                       condition=torch.tensor([0, 5]), guidance_scale=2.0)
    assert imgs.shape == (2, SIZE, SIZE, 3) and imgs.dtype == torch.uint8
    image = torch.rand(2, SIZE, SIZE, 3, generator=g) * 2 - 1
    out = pipe.img2img(image, g, strength=0.5, num_steps=4,
                       condition=torch.tensor([2, 3]), guidance_scale=1.5)
    assert out.shape == (2, SIZE, SIZE, 3)


def test_server_matches_pipeline_on_the_same_noise(pipe):
    variants, _ = make_variants(pipe, [SIZE], num_steps=3)
    assert set(variants) == {SIZE, ("cfg", SIZE)}
    srv = SamplerServer(variants, batch_buckets=(2,), max_wait_ms=1000,
                        num_classes=CFG.num_classes, device="cpu")
    try:
        futs = [srv.submit(11, variant=("cfg", SIZE), class_id=3, guidance=1.5),
                srv.submit(12, variant=("cfg", SIZE), class_id=8, guidance=1.5)]
        srv.start()
        served = np.stack([f.result(timeout=WAIT) for f in futs])
    finally:
        srv.stop()
    noise = torch.stack([torch.randn((8, 8, 4), generator=torch.Generator().manual_seed(s))
                         for s in (11, 12)])
    direct = pipe.sample(None, batch=2, image_size=SIZE, num_steps=3, init_noise=noise,
                         condition=torch.tensor([3, 8]), guidance_scale=1.5).numpy()
    np.testing.assert_array_equal(served, direct)


def test_deep_cache_on_a_dit_raises(pipe):
    with pytest.raises(ValueError, match="DeepCache"):
        pipe.sample(torch.Generator().manual_seed(0), batch=1, image_size=SIZE,
                    num_steps=4, cache_interval=2)


def test_spans_recorded_when_tracing_and_absent_when_off(pipe):
    dit = pipe.unet
    before = len(profiling.records())
    calls = dit.attention_calls
    pipe.sample(torch.Generator().manual_seed(0), batch=2, image_size=SIZE, num_steps=2,
                condition=torch.tensor([1, 2]), guidance_scale=1.5)
    assert len(profiling.records()) == before
    # 2 steps x 2 CFG forwards x depth 2
    assert dit.attention_calls - calls == 8
    with profiling.tracing() as recs:
        pipe.sample(torch.Generator().manual_seed(0), batch=2, image_size=SIZE,
                    num_steps=2, condition=torch.tensor([1, 2]), guidance_scale=1.5)
    att = [r for r in recs if r.name == "dit.attention"]
    assert len(att) == 8
    assert all(r.attrs == {"rows": 2, "tokens": 16, "heads": 4, "head_dim": 16} for r in att)
    emb = [r for r in recs if r.name == "dit.embed"]
    assert len(emb) == 4 and all(r.attrs == {"rows": 2} for r in emb)
    unets = {r.id: r for r in recs if r.name == "pipeline.unet"}
    assert len(unets) == 4 and all(r.attrs["tokens"] == 16 for r in unets.values())
    assert all(r.parent in unets for r in att + emb)


def test_sampling_cli_builds_the_dit(tmp_path, weights, capsys):
    argv = ["--config", "dit-tiny", "-s", str(SIZE), "-n", "2", "-t", "3", "-d", "cpu",
            "--class-id", "4", "--guidance-scale", "1.5", "-dp", str(tmp_path / "none.pt"),
            "-decp", str(tmp_path / "none.ckpt"), "-o", str(tmp_path / "a")]
    sample_ldm.main(argv)
    assert "Loaded checkpoint" not in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "a")) == ["0.png", "1.png"]
    dit = port_dit(weights)
    torch.save(dit.state_dict(), tmp_path / "dit.pt")
    argv[argv.index("-dp") + 1] = str(tmp_path / "dit.pt")
    args = sample_ldm.build_parser().parse_args(argv)
    sample_ldm.check_args(args)
    assert args.num_classes == CFG.num_classes
    built = sample_ldm.build_pipeline(args, 0, False)
    assert "Loaded checkpoint" in capsys.readouterr().out
    assert isinstance(built.unet, DiT) and built.unet.cfg == CFG
    for name, t in dit.state_dict().items():
        assert torch.equal(built.unet.state_dict()[name], t), name
    with pytest.raises(SystemExit, match="int8"):
        sample_ldm.check_args(sample_ldm.build_parser().parse_args(
            ["--config", "dit-tiny", "--quant", "int8"]))
