"""The reference's PyTorch state_dict files in the port: utils/torch_import
and utils/torch_export against the JAX package's, the models loaded from
a converted file against the JAX forward, cli/convert against the JAX
tool byte for byte, and load_params without a converter (tiny configs,
CPU). Every state_dict is the JAX package's torch_export of seeded JAX
params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_image_generator_tpu.cli import convert as jconvert
from ldm_image_generator_tpu.config import DiscriminatorConfig as JDiscConfig
from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.models import UNet as JUNet
from ldm_image_generator_tpu.models import vae as jvae
from ldm_image_generator_tpu.utils import torch_export as jte
from ldm_image_generator_tpu.utils import torch_import as jti
from ldm_image_generator_tpu.utils.checkpoint import load_params as jload
from ldm_image_generator_tpu_torch.cli import convert as tconvert
from ldm_image_generator_tpu_torch.config import DiscriminatorConfig, UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import flatten_tree, flax_tree, load_flax_params
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import (
    Decoder,
    Discriminator,
    Encoder,
    VectorQuantizer,
)
from ldm_image_generator_tpu_torch.utils import checkpoint as ck
from ldm_image_generator_tpu_torch.utils import torch_export as tte
from ldm_image_generator_tpu_torch.utils import torch_import as tti

torch.set_num_threads(1)

TOL = dict(rtol=5e-4, atol=5e-5)
KINDS = ("encoder", "decoder", "quantizer", "discriminator", "unet", "ddpm")
# the configs cli/convert --config tiny takes for each kind
JVCFG, VCFG = JVAEConfig().tiny(), VAEConfig().tiny()
JUCFG, UCFG = JUNetConfig().tiny(), UNetConfig().tiny()
JDCFG, DCFG = JDiscConfig(), DiscriminatorConfig()
SIDE = 16


def _input(kind: str) -> jnp.ndarray:
    """The init/forward input of a kind: images, latents, tokens."""
    if kind in ("encoder", "discriminator"):
        return jnp.zeros((1, SIDE, SIDE, 3))
    if kind == "decoder":
        return jnp.zeros((1, SIDE // 2, SIDE // 2, 8))
    if kind == "quantizer":
        return jnp.zeros((1, 4, 8))
    return jnp.zeros((1, SIDE, SIDE, 3 if kind == "ddpm" else 8))


def jax_params(kind: str, seed: int = 0) -> dict:
    """Seeded JAX params of a kind (ddpm: the 3-channel UNet)."""
    key = jax.random.PRNGKey(seed)
    x = _input(kind)
    if kind in ("unet", "ddpm"):
        cfg = JUNetConfig(input_channels=x.shape[-1]).tiny()
        return jax.jit(JUNet(cfg).init)({"params": key, "moe": key, "sd": key}, x,
                                        jnp.zeros((1,), jnp.int32))
    module = {"encoder": lambda: jvae.Encoder(JVCFG),
              "decoder": lambda: jvae.Decoder(JVCFG),
              "quantizer": lambda: jvae.VectorQuantizer(JVCFG.num_embeddings,
                                                        JVCFG.embedding_dim),
              "discriminator": lambda: jvae.Discriminator(JDCFG)}[kind]()
    return jax.jit(module.init)(key, x)


def jax_export(kind: str, params) -> dict:
    return {"encoder": lambda: jte.export_encoder(params, JVCFG),
            "decoder": lambda: jte.export_decoder(params, JVCFG),
            "quantizer": lambda: jte.export_quantizer(params),
            "discriminator": lambda: jte.export_discriminator(params, JDCFG),
            "unet": lambda: jte.export_unet(params, JUCFG),
            "ddpm": lambda: jte.export_ddpm(params, JUCFG)}[kind]()


def jax_import(kind: str, sd) -> dict:
    return {"encoder": lambda: jti.convert_encoder(sd, JVCFG),
            "decoder": lambda: jti.convert_decoder(sd, JVCFG),
            "quantizer": lambda: jti.convert_quantizer(sd),
            "discriminator": lambda: jti.convert_discriminator(sd, JDCFG),
            "unet": lambda: jti.convert_unet(sd, JUCFG),
            "ddpm": lambda: jti.convert_ddpm(sd, JUCFG)}[kind]()


def port_import(kind: str, sd) -> dict:
    return {"encoder": lambda: tti.convert_encoder(sd, VCFG),
            "decoder": lambda: tti.convert_decoder(sd, VCFG),
            "quantizer": lambda: tti.convert_quantizer(sd),
            "discriminator": lambda: tti.convert_discriminator(sd, DCFG),
            "unet": lambda: tti.convert_unet(sd, UCFG),
            "ddpm": lambda: tti.convert_ddpm(sd, UCFG)}[kind]()


def port_export(kind: str, tree) -> dict:
    return {"encoder": lambda: tte.export_encoder(tree, VCFG),
            "decoder": lambda: tte.export_decoder(tree, VCFG),
            "quantizer": lambda: tte.export_quantizer(tree),
            "discriminator": lambda: tte.export_discriminator(tree, DCFG),
            "unet": lambda: tte.export_unet(tree, UCFG),
            "ddpm": lambda: tte.export_ddpm(tree, UCFG)}[kind]()


def port_module(kind: str):
    """A port module of the kind's config on the CPU (weights zero-seeded;
    a load replaces them)."""
    return {"encoder": lambda: Encoder(VCFG, device="cpu"),
            "decoder": lambda: Decoder(VCFG, device="cpu"),
            "quantizer": lambda: VectorQuantizer(VCFG.num_embeddings, VCFG.embedding_dim,
                                                 device="cpu"),
            "discriminator": lambda: Discriminator(DCFG, device="cpu"),
            "unet": lambda: UNet(UCFG, device="cpu"),
            "ddpm": lambda: UNet(UNetConfig(input_channels=3).tiny(), device="cpu")}[kind]()


@pytest.fixture(scope="module")
def torch_files(tmp_path_factory):
    """{kind: (JAX params, path of the reference-layout .pt file)}."""
    d = tmp_path_factory.mktemp("pt")
    out = {}
    for i, kind in enumerate(KINDS):
        params = jax_params(kind, seed=i)
        path = str(d / f"{kind}.pt")
        jte.save_state_dict(path, jax_export(kind, params))
        out[kind] = (params, path)
    return out


def assert_trees_bitwise(got, want) -> None:
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        g, w = np.asarray(fg[k]), np.asarray(fw[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_converted_tree_is_jax_bitwise(torch_files, kind):
    """The port's convert_* of a reference file: JAX torch_import's tree,
    every leaf bitwise, and the JAX params the file was exported from."""
    params, path = torch_files[kind]
    got = port_import(kind, tti.load_state_dict(path))
    assert_trees_bitwise(got, jax_import(kind, jti.load_state_dict(path)))
    assert_trees_bitwise(got, jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("kind", ["ddpm", "decoder"])
def test_model_from_torch_file_matches_jax_forward(torch_files, kind):
    """The DDPM UNet and the decoder loaded from the reference file
    through load_params' converter give the JAX forward at the fp32
    tolerance."""
    params, path = torch_files[kind]
    fixed = dict(input_channels=3, fixed_expert_indices=(0, 1))
    module = (UNet(UNetConfig(**fixed).tiny(), device="cpu") if kind == "ddpm"
              else port_module(kind))
    load_flax_params(module, ck.load_params(path, lambda sd: port_import(kind, sd)))
    rng = np.random.default_rng(5)
    if kind == "ddpm":
        x = rng.normal(size=(2, SIDE, SIDE, 3)).astype(np.float32)
        t = np.array([5, 700], np.int32)
        ref = jax.jit(JUNet(JUNetConfig(**fixed).tiny()).apply)(
            params, jnp.asarray(x), jnp.asarray(t))
        got = module(torch.from_numpy(x), torch.from_numpy(t))
    else:
        x = rng.normal(size=(2, SIDE // 2, SIDE // 2, 8)).astype(np.float32)
        ref = jvae.Decoder(JVCFG).apply(params, jnp.asarray(x))
        got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_port_export_equals_jax_export(torch_files, kind):
    """export_* of a port module (its flax_tree) against the JAX package's
    export_* of the same params: the same keys, every array bitwise."""
    params, _ = torch_files[kind]
    module = load_flax_params(port_module(kind), jax.tree.map(np.asarray, params))
    got, want = port_export(kind, flax_tree(module)), jax_export(kind, params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_convert_cli_is_the_jax_tool_byte_for_byte(torch_files, tmp_path, kind, capsys):
    """cli/convert .pt -> msgpack writes the JAX tool's bytes; --to-torch
    gives back the reference file's tensors, bitwise, as the JAX tool's
    --to-torch does."""
    params, path = torch_files[kind]
    j, t = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jconvert.main([path, "--kind", kind, "--config", "tiny", "-o", j])
    tconvert.main([path, "--kind", kind, "--config", "tiny", "-o", t])
    with open(j, "rb") as fj, open(t, "rb") as ft:
        assert fj.read() == ft.read()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1].replace(t, j)
    back = str(tmp_path / "back.pt")
    tconvert.main([t, "--kind", kind, "--config", "tiny", "--to-torch", "-o", back])
    jback = str(tmp_path / "jback.pt")
    jconvert.main([j, "--kind", kind, "--config", "tiny", "--to-torch", "-o", jback])
    ref = torch.load(path, weights_only=True)
    for other in (torch.load(back, weights_only=True), torch.load(jback, weights_only=True)):
        assert list(other) == list(ref)
        for k in ref:
            assert torch.equal(other[k], ref[k]), k
    # the converted file loads as the JAX package's load_params reads it
    assert_trees_bitwise(ck.load_params(t), jax.tree.map(
        np.asarray, jload(j, params)))
    with pytest.raises(SystemExit, match="already a torch checkpoint"):
        tconvert.main([path, "--kind", kind, "--to-torch"])


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_torch_file_in_another_dtype_loads_cast(torch_files, tmp_path, dtype):
    """A reference file saved in half precision loads into the fp32 UNet,
    each value cast to the parameter's dtype."""
    _, path = torch_files["ddpm"]
    sd = torch.load(path, weights_only=True)
    half = str(tmp_path / "half.pt")
    torch.save({k: v.to(dtype) for k, v in sd.items()}, half)
    module = port_module("ddpm")
    load_flax_params(module, ck.load_params(half, lambda s: tti.convert_ddpm(s, UCFG)))
    want = port_module("ddpm")
    load_flax_params(want, ck.load_params(path, lambda s: tti.convert_ddpm(s, UCFG)))
    for (n, a), b in zip(module.state_dict().items(), want.state_dict().values()):
        assert a.dtype == torch.float32
        assert torch.equal(a, b.to(dtype).float()), n


@pytest.mark.parametrize("head", ["zip", "pickle"])
def test_torch_file_without_converter_raises_jax_message(torch_files, tmp_path, head):
    """load_params on a torch file (zip, or the legacy pickle format)
    without a converter raises the JAX package's message, and the JAX
    package's load_params the same."""
    _, path = torch_files["quantizer"]
    if head == "pickle":
        sd = torch.load(path, weights_only=True)
        path = str(tmp_path / "legacy.pt")
        torch.save(sd, path, _use_new_zipfile_serialization=False)
    with open(path, "rb") as f:
        assert f.read(2) == (b"PK" if head == "zip" else b"\x80\x02")
    msg = f"{path} is a PyTorch checkpoint; pass the matching utils.torch_import converter"
    with pytest.raises(ValueError, match=msg) as port_err:
        ck.load_params(path)
    with pytest.raises(ValueError) as jax_err:
        jload(path, None)
    assert port_err.value.args == jax_err.value.args
    got = ck.load_params(path, tti.convert_quantizer)
    assert_trees_bitwise(got, jax_import("quantizer", jti.load_state_dict(path)))
