"""The port's sampling slice end to end against the JAX package (tiny
config, CPU, fp32), the default UNet's parameter count, the port's
imports, and the rule that a CUDA request without a card raises."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.pipelines import LDMPipeline as JPipeline
from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import decoder_from_flax, unet_from_flax
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

torch.set_num_threads(1)

IMAGE = 16   # tiny VAE downscale 2 -> 8x8 latent: one windowed, one full-map stage
STEPS = 5


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, its UNet and Decoder params, port pipeline on the
    same weights), tiny config with routing pinned to experts (0, 1)."""
    ucfg = JUNetConfig(fixed_expert_indices=(0, 1)).tiny()
    vcfg = JVAEConfig().tiny()
    jp = JPipeline(ucfg, vcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1, 8, 8, ucfg.input_channels))
    up = jax.jit(jp.unet.init)({"params": key, "moe": key}, z0,
                               jnp.zeros((1,), jnp.int32))
    dp = jax.jit(jp.decoder.init)(key, z0)
    np_tree = lambda p: jax.tree.map(np.asarray, p)
    tp = LDMPipeline(
        unet_from_flax(np_tree(up), UNetConfig(fixed_expert_indices=(0, 1)).tiny(),
                       device="cpu"),
        decoder_from_flax(np_tree(dp), VAEConfig().tiny(), device="cpu"),
        dtype=torch.float32)
    return jp, up, dp, tp


def test_tiny_sample_matches_jax_within_one_level(pipes):
    jp, up, dp, tp = pipes
    noise = np.random.default_rng(0).normal(size=(2, 8, 8, 8)).astype(np.float32)
    ref = np.asarray(jp.sample(up, dp, jax.random.PRNGKey(1), batch=2,
                               image_size=IMAGE, num_steps=STEPS,
                               init_noise=jnp.asarray(noise)))
    img, z = tp.sample(batch=2, image_size=IMAGE, num_steps=STEPS,
                       init_noise=torch.from_numpy(noise), return_latent=True)
    assert img.dtype == torch.uint8 and img.shape == ref.shape == (2, 16, 16, 3)
    diff = np.abs(img.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert torch.isfinite(z).all()
    # the FiLM-schedule path and the inline-FiLM path agree
    img_inline = tp.sample(batch=2, image_size=IMAGE, num_steps=STEPS,
                           init_noise=torch.from_numpy(noise), film_cache=False)
    diff = np.abs(img_inline.numpy().astype(np.int32) - img.numpy().astype(np.int32))
    assert diff.max() <= 1, diff.max()


def test_film_cache_miss_raises(pipes):
    tp = pipes[3]
    denoise = tp.denoise_fn(latent=8, num_steps=STEPS)
    x = torch.zeros(1, 8, 8, 8)
    denoise(x, 999)
    with pytest.raises(KeyError, match="FiLM schedule"):
        denoise(x, 998)


def test_default_unet_param_count_matches_jax():
    port = sum(p.numel() for p in UNet(UNetConfig(), device="meta").parameters())
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: JUNet(JUNetConfig()).init(
        {"params": key, "moe": key}, jnp.zeros((1, 32, 32, 8)),
        jnp.zeros((1,), jnp.int32)))
    ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert port == ref
    assert abs(port - 385_700_000) / 385_700_000 < 0.01


PORT_MODULES = [
    "ldm_image_generator_tpu_torch",
    "ldm_image_generator_tpu_torch.config",
    "ldm_image_generator_tpu_torch.convert",
    "ldm_image_generator_tpu_torch.pipelines",
    "ldm_image_generator_tpu_torch.cli.common",
    "ldm_image_generator_tpu_torch.cli.convert",
    "ldm_image_generator_tpu_torch.cli.sample_ab",
    "ldm_image_generator_tpu_torch.cli.sample_ddpm",
    "ldm_image_generator_tpu_torch.cli.sample_ldm",
    "ldm_image_generator_tpu_torch.cli.train_ddpm",
    "ldm_image_generator_tpu_torch.cli.train_ldm",
    "ldm_image_generator_tpu_torch.cli.train_vae",
    "ldm_image_generator_tpu_torch.cli.vq_breakdown",
    "ldm_image_generator_tpu_torch.data.dataset",
    "ldm_image_generator_tpu_torch.data.loader",
    "ldm_image_generator_tpu_torch.data.native_loader",
    "ldm_image_generator_tpu_torch.diffusion.ddpm",
    "ldm_image_generator_tpu_torch.diffusion.dpm_solver",
    "ldm_image_generator_tpu_torch.diffusion.engine",
    "ldm_image_generator_tpu_torch.kernels._build",
    "ldm_image_generator_tpu_torch.kernels.block_core",
    "ldm_image_generator_tpu_torch.kernels.ffn_block",
    "ldm_image_generator_tpu_torch.kernels.vq",
    "ldm_image_generator_tpu_torch.kernels.window_attention",
    "ldm_image_generator_tpu_torch.kernels.workloads",
    "ldm_image_generator_tpu_torch.models.layers",
    "ldm_image_generator_tpu_torch.models.unet",
    "ldm_image_generator_tpu_torch.models.vae",
    "ldm_image_generator_tpu_torch.ops.norm",
    "ldm_image_generator_tpu_torch.ops.sinusoidal",
    "ldm_image_generator_tpu_torch.ops.window",
    "ldm_image_generator_tpu_torch.parallel.mesh",
    "ldm_image_generator_tpu_torch.parallel.pipeline",
    "ldm_image_generator_tpu_torch.parallel.pipelined_unet",
    "ldm_image_generator_tpu_torch.train.eval",
    "ldm_image_generator_tpu_torch.train.steps",
    "ldm_image_generator_tpu_torch.utils.checkpoint",
    "ldm_image_generator_tpu_torch.utils.debug",
    "ldm_image_generator_tpu_torch.utils.metrics",
    "ldm_image_generator_tpu_torch.utils.profiling",
    "ldm_image_generator_tpu_torch.utils.quality",
    "ldm_image_generator_tpu_torch.utils.torch_export",
    "ldm_image_generator_tpu_torch.utils.torch_import",
]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'flax', 'optax', 'orbax', 'msgpack')\n"
        "             or n.startswith(('jax.', 'flax.', 'optax.', 'orbax.', 'msgpack.'))\n"
        "             or n == 'ldm_image_generator_tpu'\n"
        "             or n.startswith('ldm_image_generator_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_port_and_chip_smoke_import_statements_name_no_jax():
    """Every import statement of the port's modules and of chip_smoke.py
    (inside functions too, which importing does not run) names nothing
    of JAX, flax, optax or the JAX package."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "ldm_image_generator_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    banned = ("jax", "flax", "optax", "orbax", "ldm_image_generator_tpu")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (str(path), name)


def test_cuda_request_without_card_raises_in_pipeline_and_cli(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ldm_image_generator_tpu_torch.cli import sample_ldm

    with pytest.raises(RuntimeError, match="cuda"):
        LDMPipeline.random(UNetConfig().tiny(), VAEConfig().tiny(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        sample_ldm.main(["--config", "tiny", "-s", "16", "-t", "2"])


def test_sample_ab_summary():
    """The A/B tool's summary: medians per tree and batch, and each
    round's ratio of this tree's median to the other's."""
    from ldm_image_generator_tpu_torch.cli.sample_ab import summarize

    runs = [(0, "other", {"b1": [0.30, 0.20], "b4": [0.5], "b1_device_busy_s": 0.06}),
            (0, "this", {"b1": [0.10, 0.20], "b4": [0.4]}),
            (1, "this", {"b1": [0.30, 0.30], "b4": [0.6]}),
            (1, "other", {"b1": [0.20, 0.20], "b4": [0.5]})]
    s = summarize(runs)
    assert s["b1"]["this"]["median_s"] == pytest.approx(0.25)
    assert s["b1"]["other"]["median_s"] == pytest.approx(0.20)
    assert s["b1"]["this"]["samples"] == 4 and s["b1"]["this"]["min_s"] == 0.10
    assert s["b1"]["other"]["device_busy_s"] == 0.06
    assert s["b1"]["this"]["device_busy_s"] is None
    assert s["b1"]["this_lower_in_rounds"] == "1/2"
    assert s["b1"]["round_ratios"] == pytest.approx([0.6, 1.5])
    assert s["b1"]["median_round_ratio"] == pytest.approx(1.05)
    assert s["b4"]["other"]["images_per_s"] == pytest.approx(8.0)
    assert s["b4"]["this_over_other_median"] == pytest.approx(1.0)
