"""Parameter files: the port's flax-msgpack codec (utils/checkpoint.py)
against the JAX package's save_params / load_params and flax's reader,
convert.py's file loads and their messages, and the CLIs writing and
reading them (tiny config, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ldm_image_generator_tpu.config import UNetConfig as JUNetConfig
from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
from ldm_image_generator_tpu.pipelines import LDMPipeline as JPipeline
from ldm_image_generator_tpu.utils.checkpoint import load_params as jload
from ldm_image_generator_tpu.utils.checkpoint import save_params as jsave
from ldm_image_generator_tpu_torch.cli import sample_ldm, train_ldm, train_vae
from ldm_image_generator_tpu_torch.config import UNetConfig, VAEConfig
from ldm_image_generator_tpu_torch.convert import flax_tree, load_flax_file, save_flax_file
from ldm_image_generator_tpu_torch.models.unet import UNet
from ldm_image_generator_tpu_torch.models.vae import Decoder, Encoder
from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
from ldm_image_generator_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

FIXED = dict(fixed_expert_indices=(0, 1))


def seeded(cls, cfg, seed):
    return cls(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def assert_same_params(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


def assert_trees_equal(got, want) -> None:
    """Nested trees with the same keys and bitwise equal leaves of the
    same dtype (a torch bfloat16 leaf against a numpy/JAX bfloat16 one)."""
    assert isinstance(got, dict) and set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_trees_equal(g, w)
            continue
        w = np.asarray(w)
        if isinstance(g, torch.Tensor):
            assert g.dtype == torch.bfloat16 and w.dtype.name == "bfloat16", k
            g = g.view(torch.int16).numpy()
            w = w.view(np.int16)
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_jax_written_file_loads_into_the_port_and_samples_as_jax(tmp_path):
    """UNet and decoder files written by the JAX package's save_params:
    the port loads them bitwise, and its sample equals the JAX package's
    sample from the same files (read back by its load_params) within
    one uint8 level."""
    unet = seeded(UNet, UNetConfig(**FIXED).tiny(), 1)
    decoder = seeded(Decoder, VAEConfig().tiny(), 2)
    paths = [str(tmp_path / "ddpm.msgpack"), str(tmp_path / "dec.msgpack")]
    for m, path in zip((unet, decoder), paths):
        jsave(path, jax.tree.map(jnp.asarray, flax_tree(m)))
    port_unet = load_flax_file(seeded(UNet, UNetConfig(**FIXED).tiny(), 5), paths[0])
    port_dec = load_flax_file(seeded(Decoder, VAEConfig().tiny(), 6), paths[1])
    assert_same_params(port_unet, unet)
    assert_same_params(port_dec, decoder)

    jp = JPipeline(JUNetConfig(**FIXED).tiny(), JVAEConfig().tiny(), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    z0 = jnp.zeros((1, 8, 8, 8))
    up = jload(paths[0], jax.eval_shape(lambda: jp.unet.init(
        {"params": key, "moe": key}, z0, jnp.zeros((1,), jnp.int32))))
    dp = jload(paths[1], jax.eval_shape(lambda: jp.decoder.init(key, z0)))
    x_t = np.random.default_rng(0).normal(size=(2, 8, 8, 8)).astype(np.float32)
    ref = np.asarray(jp.sample(up, dp, key, batch=2, image_size=16, num_steps=3,
                               init_noise=jnp.asarray(x_t)))
    img = LDMPipeline(port_unet, port_dec, dtype=torch.float32).sample(
        batch=2, image_size=16, num_steps=3, init_noise=torch.from_numpy(x_t))
    diff = np.abs(img.numpy().astype(np.int32) - ref.astype(np.int32))
    assert img.shape == ref.shape and diff.max() <= 1, diff.max()


def test_port_written_file_reads_back_in_flax(tmp_path):
    """A class-conditional UNet written by the port: flax's msgpack_restore
    gives its {"params": ...} tree bitwise, and the JAX package's
    load_params restores it into the JAX UNet's own tree."""
    cfg = UNetConfig(num_classes=3, **FIXED).tiny()
    unet = seeded(UNet, cfg, 2)
    path = str(tmp_path / "ddpm.pt")
    save_flax_file(unet, path)
    with open(path, "rb") as f:
        back = serialization.msgpack_restore(f.read())
    assert_trees_equal(back, flax_tree(unet))
    key = jax.random.PRNGKey(0)
    target = jax.eval_shape(lambda: JPipeline(
        JUNetConfig(num_classes=3, **FIXED).tiny(), JVAEConfig().tiny()).unet.init(
        {"params": key, "moe": key}, jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,), jnp.int32)))
    restored = jload(path, target)
    assert jax.tree.structure(restored) == jax.tree.structure(target)
    assert_trees_equal(jax.tree.map(np.asarray, restored), flax_tree(unet))


def mixed_tree() -> dict:
    """Leaves of every type a parameter file holds, and numpy scalars."""
    rng = np.random.default_rng(0)
    return {"params": {
        "dense": {"kernel": rng.normal(size=(40, 24)).astype(np.float32),
                  "bias": np.zeros((24,), np.float32)},
        "w_bf16": np.asarray(jnp.asarray(rng.normal(size=(6, 5)), jnp.bfloat16)),
        "w_int8": rng.integers(-127, 128, (9, 4), dtype=np.int8),
        "ids": np.arange(-3, 300, dtype=np.int32),
        "w_f16": rng.normal(size=(3,)).astype(np.float16),
        "empty": np.zeros((0, 3), np.float32)},
        "step": np.int32(12), "scale": np.float32(0.5)}


def test_bf16_and_int8_leaves_round_trip(tmp_path):
    """bf16, int8, int32, fp16 leaves and numpy scalars: a JAX-written file
    reads in the port (bf16 as a torch.bfloat16 tensor of the same bits),
    and the port writes it back byte for byte as flax does."""
    tree = mixed_tree()
    jpath, ppath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jsave(jpath, tree)
    got = ck.load_params(jpath)
    assert_trees_equal(got, tree)
    assert got["params"]["w_bf16"].dtype == torch.bfloat16
    ck.save_params(ppath, got)
    with open(jpath, "rb") as fj, open(ppath, "rb") as fp:
        assert fj.read() == fp.read()
    with open(ppath, "rb") as f:
        assert_trees_equal(serialization.msgpack_restore(f.read()), tree)


def test_chunked_file_reads_back(tmp_path, monkeypatch):
    """Leaves over MAX_CHUNK_SIZE bytes (set small here) are written in
    flax's chunked form: a JAX-written chunked file reads in the port,
    and the port's own chunked file is flax's, byte for byte."""
    tree = mixed_tree()
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    jpath, ppath = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jsave(jpath, tree)
    with open(jpath, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    got = ck.load_params(jpath)
    assert_trees_equal(got, tree)
    ck.save_params(ppath, got)
    with open(jpath, "rb") as fj, open(ppath, "rb") as fp:
        assert fj.read() == fp.read()


@pytest.mark.parametrize("head", [b"PK\x03\x04", b"\x80\x02"], ids=["zip", "pickle"])
def test_torch_file_raises_naming_a12(tmp_path, head):
    """A reference (torch) UNet file in either torch.save format, made by
    the JAX package's torch_export from seeded weights: load_params
    without a converter raises the JAX package's message (before A12
    ported the converters every such file raised), and the sampling CLI
    loads it through convert_ddpm into exactly those weights."""
    from ldm_image_generator_tpu.utils import torch_export as jte

    cfg = UNetConfig().tiny()
    want = seeded(UNet, cfg, 7)
    path = str(tmp_path / "ddpm.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                jte.export_ddpm(flax_tree(want), JUNetConfig().tiny()).items()},
               path, _use_new_zipfile_serialization=head.startswith(b"PK"))
    with open(path, "rb") as f:
        assert f.read(len(head)) == head
    msg = (f"{path} is a PyTorch checkpoint; pass the matching "
           "utils.torch_import converter to load it")
    with pytest.raises(ValueError) as err:
        ck.load_params(str(path))
    assert err.value.args == (msg,)
    with pytest.raises(ValueError) as jerr:
        jload(path, None)
    assert jerr.value.args == (msg,)
    args = sample_ldm.build_parser().parse_args(
        ["--config", "tiny", "-d", "cpu", "-dp", path, "-decp", str(tmp_path / "none")])
    assert_same_params(sample_ldm.build_pipeline(args, 0, False)._src[0], want)
    sample_ldm.main(["--config", "tiny", "-d", "cpu", "-dp", path, "-s", "16",
                     "-t", "2", "-o", str(tmp_path / "out")])
    assert (tmp_path / "out" / "0.png").stat().st_size > 0


@pytest.mark.parametrize("classes,match", [
    ("5", r"param class_embed\.embedding shape \(4, 1024\) vs expected \(6, 1024\)"),
    ("0", "param names differ"),
], ids=["more-classes", "no-classes"])
def test_wrong_config_gives_the_mismatch_message(tmp_path, classes, match):
    """A parameter file of another model config (3 classes) exits with
    the JAX CLI's message, naming the first misshapen parameter."""
    path = str(tmp_path / "ddpm.pt")
    save_flax_file(seeded(UNet, UNetConfig(num_classes=3).tiny(), 0), path)
    argv = ["--config", "tiny", "-d", "cpu", "-dp", path, "--num-classes", classes]
    with pytest.raises(SystemExit, match="does not match this model config") as e:
        sample_ldm.main(argv)
    assert "Check the --config preset" in str(e.value)
    with pytest.raises(SystemExit, match=match):
        sample_ldm.main(argv)


def _images(tmp_path, n=4):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            d / f"{i}.png")
    return str(d)


def test_train_ldm_then_sample_ldm_cli(tmp_path, capsys, monkeypatch):
    """train_ldm writes -mp and the EMA file (the trained UNet and its EMA,
    bitwise); a second run loads -mp; sample_ldm -dp samples from either."""
    monkeypatch.chdir(tmp_path)
    imgs = _images(tmp_path)
    argv = [imgs, "--config", "tiny", "-s", "32", "-b", "2", "-e", "1", "-d", "cpu",
            "-mp", "model.pt", "--ema", "0.9"]
    state = train_ldm.main(argv)
    assert "saved model.pt, model.pt.ema" in capsys.readouterr().out
    cfg = UNetConfig().tiny()
    assert_same_params(load_flax_file(seeded(UNet, cfg, 9), "model.pt"), state.params)
    ema = load_flax_file(seeded(UNet, cfg, 9), "model.pt.ema").state_dict()
    assert all(torch.equal(ema[n], v) for n, v in state.ema_params.items())
    train_ldm.main(argv[:-2])
    assert "Loaded checkpoint: model.pt" in capsys.readouterr().out
    for path in ("model.pt", "model.pt.ema"):
        sample_ldm.main(["--config", "tiny", "-s", "32", "-n", "2", "-t", "2", "-d", "cpu",
                         "-dp", path, "-o", "out"])
        out = capsys.readouterr().out
        assert f"Loaded checkpoint: {path}" in out and "saved 2 images" in out
        assert (tmp_path / "out" / "1.png").stat().st_size > 0


def test_train_vae_then_sample_ldm_cli(tmp_path, capsys, monkeypatch):
    """train_vae writes its four files (bitwise the trained models) and a
    second run loads them; sample_ldm -decp takes its decoder and
    train_ldm -ep its encoder."""
    monkeypatch.chdir(tmp_path)
    imgs = _images(tmp_path)
    files = ["-ep", "enc.pt", "-dp", "dec.pt", "-qp", "q.pt", "-discp", "disc.pt"]
    argv = [imgs, "--config", "tiny", "-d", "cpu", "-s", "32", "-b", "2", "-e", "1",
            "-r", "out", *files]
    state = train_vae.main(argv)
    assert "saved enc.pt, dec.pt, q.pt, disc.pt" in capsys.readouterr().out
    vcfg = VAEConfig().tiny()
    assert_same_params(load_flax_file(seeded(Decoder, vcfg, 9), "dec.pt"),
                       state.vae_params["decoder"])
    assert_same_params(load_flax_file(seeded(Encoder, vcfg, 9), "enc.pt"),
                       state.vae_params["encoder"])
    train_vae.main(argv)
    out = capsys.readouterr().out
    assert all(f"Loaded checkpoint: {p}" in out for p in files[1::2])
    sample_ldm.main(["--config", "tiny", "-s", "32", "-t", "2", "-d", "cpu",
                     "-decp", "dec.pt", "-o", "samples"])
    assert "Loaded checkpoint: dec.pt" in capsys.readouterr().out
    assert (tmp_path / "samples" / "0.png").stat().st_size > 0
    train_ldm.main([imgs, "--config", "tiny", "-s", "32", "-b", "2", "-e", "1",
                    "-d", "cpu", "-ep", "enc.pt"])
    assert "Loaded checkpoint: enc.pt" in capsys.readouterr().out
