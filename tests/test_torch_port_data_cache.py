"""The port's on-disk image and latent cache and its native decoder
against the JAX package (CPU): the cache keys and file names, a cache
directory the JAX package built read with no decode, the native decode
bitwise the JAX package's library (the same source) and near PIL, the
batch API against single images, a corrupt file, set_size, the latent
cache against JAX's LatentImageDataset on the same encoder weights, the
encoder fingerprint in the latent key, the loader's fp16 fast path, the
three trainer CLIs on a reused cache, and the port's independence of the
JAX package's native/ directory.

The native tests skip only where g++ or the libjpeg / libpng headers are
missing, and say which."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldm_image_generator_tpu_torch.data import dataset as tdataset
from ldm_image_generator_tpu_torch.data import native_loader
from ldm_image_generator_tpu_torch.data.loader import BatchLoader

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (width, height, format): wide and tall sources downscaled, a small one
# upscaled, a square one
SHAPES = [(40, 30, "jpg"), (20, 50, "png"), (64, 64, "jpg"), (12, 10, "png"),
          (33, 47, "jpg"), (50, 22, "png")]
SIZE = 32


def _native_or_skip():
    """Skip where the decoder cannot be built here, naming what is
    missing; where it can, it must."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native decoder cannot be built")
    if not os.path.exists("/usr/include/jpeglib.h"):
        pytest.skip("libjpeg headers (/usr/include/jpeglib.h) not found")
    if not any(os.path.exists(p) for p in ("/usr/include/png.h",
                                            "/usr/include/libpng16/png.h")):
        pytest.skip("libpng headers (png.h) not found")
    assert native_loader.available(), native_loader.unavailable_reason()


def _write_images(d, shapes=SHAPES, seed=0):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (w, h, fmt) in enumerate(shapes):
        # smooth content (as photos are) plus noise
        base = rng.integers(0, 255, (h // 4 + 1, w // 4 + 1, 3)).astype(np.float32)
        img = np.kron(base, np.ones((4, 4, 1)))[:h, :w]
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"{i}.{fmt}"))
    return str(d)


@pytest.fixture
def imgs(tmp_path):
    return _write_images(tmp_path / "imgs")


def test_cache_keys_match_jax_and_a_jax_cache_is_reused(imgs, tmp_path):
    """The same files, keys and .npy names as the JAX ImageDataset for
    images (and for latents without an encoder fingerprint); on a cache
    directory the JAX package built, the port decodes nothing and serves
    its bits."""
    from ldm_image_generator_tpu.data.dataset import ImageDataset as JImageDataset
    from ldm_image_generator_tpu.data.dataset import (
        LatentImageDataset as JLatentImageDataset,
    )

    cache = str(tmp_path / "cache")
    ref = JImageDataset([imgs], cache_dir=cache, size=SIZE)
    got = tdataset.ImageDataset([imgs], cache_dir=cache, size=SIZE)
    assert got.paths == ref.paths and got.labels == ref.labels
    assert got._cache_paths == ref._cache_paths
    assert got.built == dict(native=0, pil=0, fallback=0)
    for i in range(len(ref)):
        raw = got.load_raw(i)
        assert raw.dtype == np.float16 and not raw.flags.writeable
        np.testing.assert_array_equal(raw, ref.load_raw(i))
        assert got[i].dtype == np.float32
        np.testing.assert_array_equal(got[i], ref[i])
    jlat = JLatentImageDataset([imgs], cache_dir=str(tmp_path / "lat"), size=SIZE)
    lat = tdataset.LatentImageDataset([imgs], cache_dir=str(tmp_path / "lat"), size=SIZE)
    assert lat._cache_paths == jlat._cache_paths and lat.encoded == 0
    assert sorted(os.listdir(cache)) == sorted(os.path.basename(p)
                                               for p in ref._cache_paths)


def test_native_decode_is_the_jax_library_bitwise_and_near_pil(imgs):
    """The port's library (its own build of the same source) against the
    JAX package's native_loader, bitwise, on JPEGs and PNGs up- and
    downscaled; against PIL within the JAX tests' mean of 0.08 with the
    padding rows equal."""
    from ldm_image_generator_tpu.data import native_loader as jnative

    _native_or_skip()
    assert jnative.available()
    paths, _ = tdataset.find_images([imgs])
    for path in paths:
        nat = native_loader.preprocess_image_native(path, SIZE)
        np.testing.assert_array_equal(nat, jnative.preprocess_image_native(path, SIZE))
        pil = tdataset.preprocess_image(path, SIZE, use_native=False)
        assert nat.shape == pil.shape == (SIZE, SIZE, 3) and nat.dtype == np.float32
        pad = np.all(pil == -1.0, axis=(1, 2))
        np.testing.assert_array_equal(nat[pad], pil[pad])
        assert float(np.abs(nat - pil).mean()) < 0.08, path
    assert str(native_loader.library_path()).startswith(os.path.join(REPO, "build"))


def test_native_batch_equals_single(imgs):
    _native_or_skip()
    paths, _ = tdataset.find_images([imgs])
    out = np.full((len(paths), SIZE, SIZE, 3), 7.0, np.float32)
    got, status = native_loader.preprocess_batch_native(paths, SIZE, 3, out=out)
    assert got is out and not status.any()
    for i, path in enumerate(paths):
        np.testing.assert_array_equal(got[i], native_loader.preprocess_image_native(
            path, SIZE))


def test_corrupt_file_is_none_natively_and_item_zero_in_the_dataset(imgs, tmp_path):
    """Garbage bytes named .jpg: None from the native decoder, a failed
    slot (all -1) in a batch; in a dataset the native build hands it to
    PIL, which cannot read it either, so the item falls back to item 0."""
    _native_or_skip()
    bad_dir = tmp_path / "bad"
    bad_dir.mkdir()
    bad = bad_dir / "broken.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg at all" * 10)
    assert native_loader.preprocess_image_native(str(bad), SIZE) is None
    assert native_loader.preprocess_image_native(str(tmp_path / "missing.jpg"), SIZE) is None
    imgs_b, status = native_loader.preprocess_batch_native([str(bad)], SIZE)
    assert status[0] != 0 and np.all(imgs_b[0] == -1.0)
    ds = tdataset.ImageDataset([imgs, str(bad_dir)], cache_dir=str(tmp_path / "c"),
                               size=SIZE)
    assert ds.built == dict(native=len(SHAPES), pil=0, fallback=1)
    assert ds.labels[-1] == 1 and ds.paths[-1] == str(bad)
    np.testing.assert_array_equal(ds[len(ds) - 1], ds[0])


def test_set_size_builds_only_what_is_missing(imgs, tmp_path):
    ds = tdataset.ImageDataset([imgs], cache_dir=str(tmp_path / "c"), size=16)
    first = [ds[i] for i in range(len(ds))]
    assert sum(ds.built.values()) == len(SHAPES)
    ds.set_size(24)
    assert sum(ds.built.values()) == len(SHAPES) and ds[0].shape == (24, 24, 3)
    ds.set_size(16)
    assert sum(ds.built.values()) == 0
    for i, a in enumerate(first):
        np.testing.assert_array_equal(ds[i], a)
    again = tdataset.ImageDataset([imgs], cache_dir=str(tmp_path / "c"), size=24)
    assert sum(again.built.values()) == 0
    assert len(os.listdir(tmp_path / "c")) == 2 * len(SHAPES)


def _encoders(seed):
    """(JAX encode_fn, port encode_fn, port Encoder) of the tiny VAE
    Encoder on the same weights."""
    import jax
    import jax.numpy as jnp

    from ldm_image_generator_tpu.config import VAEConfig as JVAEConfig
    from ldm_image_generator_tpu.models import Encoder as JEncoder
    from ldm_image_generator_tpu_torch.config import VAEConfig
    from ldm_image_generator_tpu_torch.convert import encoder_from_flax

    jenc = JEncoder(JVAEConfig().tiny(), dtype=jnp.float32)
    params = jenc.init(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    jfn = jax.jit(lambda x: jenc.apply(params, x))
    enc = encoder_from_flax(jax.tree.map(np.asarray, params), VAEConfig().tiny(),
                            device="cpu")

    @torch.no_grad()
    def fn(x):
        return enc(torch.from_numpy(x)).float().numpy()

    return (lambda x: np.asarray(jfn(jnp.asarray(x)))), fn, enc


def test_latent_cache_matches_jax_latent_dataset(imgs, tmp_path):
    """The port's LatentImageDataset and JAX's on the same images and
    encoder weights (batches of 4 of the 6 images, the tail padded to 4):
    every latent within one fp16 ulp of the larger magnitude (plus 1e-6
    of the latent's max abs, the two fp32 encoders' own agreement, for
    the values near 0 whose fp16 ulp is finer), and the encoder called on
    the same padded batch shapes."""
    from ldm_image_generator_tpu.data.dataset import (
        LatentImageDataset as JLatentImageDataset,
    )

    jfn, fn, enc = _encoders(0)
    jcalls, calls = [], []
    ref = JLatentImageDataset([imgs], cache_dir=str(tmp_path / "j"), size=SIZE,
                              encode_batch=4,
                              encode_fn=lambda x: (jcalls.append(x.shape), jfn(x))[1])
    got = tdataset.LatentImageDataset(
        [imgs], cache_dir=str(tmp_path / "t"), size=SIZE, encode_batch=4,
        encode_fn=lambda x: (calls.append(x.shape), fn(x))[1],
        encoder_fingerprint=tdataset.module_fingerprint(enc))
    assert calls == jcalls == [(4, SIZE, SIZE, 3)] * 2 and got.encoded == 2
    for i in range(len(ref)):
        a, b = got.load_raw(i), ref.load_raw(i)
        assert a.dtype == np.float16 and a.shape == b.shape
        a, b = a.astype(np.float32), b.astype(np.float32)
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
        bound = ulp.astype(np.float32) + 1e-6 * np.abs(b).max()
        assert np.all(np.abs(a - b) <= bound), i


def test_encoder_fingerprint_refreshes_latents(imgs, tmp_path):
    """A second construction with the same encoder encodes nothing and
    serves the same bits; another encoder (other weights) gets fresh
    latents; without the fingerprint (the JAX package's key) that other
    encoder would have been served the stale ones."""
    _, fn0, enc0 = _encoders(0)
    _, fn1, enc1 = _encoders(1)
    cache = str(tmp_path / "c")
    make = lambda fn, fp: tdataset.LatentImageDataset(
        [imgs], cache_dir=cache, size=SIZE, encode_batch=4, encode_fn=fn,
        encoder_fingerprint=fp)
    fp0, fp1 = tdataset.module_fingerprint(enc0), tdataset.module_fingerprint(enc1)
    assert fp0 != fp1 and fp0 == tdataset.module_fingerprint(enc0)
    a = make(fn0, fp0)
    first = [a[i] for i in range(len(a))]
    again = make(fn0, fp0)
    assert again.encoded == 0
    for i, z in enumerate(first):
        np.testing.assert_array_equal(again[i], z)
    other = make(fn1, fp1)
    assert other.encoded == 2
    assert not np.array_equal(other[0], first[0])
    np.testing.assert_array_equal(
        other[0], fn1(tdataset.preprocess_image(other.paths[0], SIZE)[None])[0]
        .astype(np.float16).astype(np.float32))
    make(fn0, None)
    stale = make(fn1, None)
    assert stale.encoded == 0


@pytest.mark.parametrize("with_labels", [False, True])
def test_loader_fp16_fast_path_is_the_float32_path(imgs, tmp_path, with_labels):
    """device_cast=True yields the cache's fp16 batches, whose cast is
    bitwise the float32 batches of the same seed, which are the dataset's
    items stacked."""
    ds = tdataset.ImageDataset([imgs], cache_dir=str(tmp_path / "c"), size=SIZE)
    fast = list(BatchLoader(ds, 2, seed=3, device_cast=True, with_labels=with_labels))
    slow = list(BatchLoader(ds, 2, seed=3, with_labels=with_labels))
    assert len(fast) == len(slow) == 3
    idx = np.arange(len(ds))
    np.random.RandomState(3).shuffle(idx)
    for b, (f, s) in enumerate(zip(fast, slow)):
        if with_labels:
            np.testing.assert_array_equal(f[1], s[1])
            f, s = f[0], s[0]
        assert f.dtype == np.float16 and s.dtype == np.float32
        np.testing.assert_array_equal(f.astype(np.float32), s)
        want = np.stack([ds[int(i)] for i in idx[2 * b:2 * b + 2]])
        np.testing.assert_array_equal(s, want)


CLI_RUNS = {
    "train_vae": (["-s", "32", "-b", "2", "-e", "1", "-r", "out"], "dataset: 6 images"),
    "train_ddpm": (["-s", "32", "-b", "2", "-e", "1", "-m", "6"], "dataset: 6 images"),
    "train_ldm": (["-s", "32", "-b", "2", "-e", "1"], "dataset: 6 latents"),
}


@pytest.mark.parametrize("cli", sorted(CLI_RUNS))
def test_trainer_cli_builds_and_reuses_the_cache(tmp_path, capsys, monkeypatch, cli):
    """Each trainer CLI (tiny, CPU) builds ./dataset_cache/ on its first
    run and decodes (or encodes) nothing on the second."""
    import importlib

    monkeypatch.chdir(tmp_path)
    imgs = _write_images(tmp_path / "imgs")
    main = importlib.import_module(f"ldm_image_generator_tpu_torch.cli.{cli}").main
    flags, seen = CLI_RUNS[cli]
    argv = [imgs, "--config", "tiny", "-d", "cpu", *flags]
    built = "latent cache ./dataset_cache/: " if cli == "train_ldm" else \
        "cache ./dataset_cache/: "
    for run, want in ((0, "1 encoder calls" if cli == "train_ldm" else "6 of 6 decoded"),
                      (1, "0 encoder calls" if cli == "train_ldm" else "0 of 6 decoded")):
        main(argv)
        out = capsys.readouterr().out
        assert seen in out and built + want in out, out
    assert len(os.listdir(tmp_path / "dataset_cache")) == len(SHAPES)


def test_port_reads_nothing_under_native(imgs, tmp_path):
    """The port builds and loads its own library: a process that builds
    an image cache through it opens nothing under the repository's
    native/ directory and maps no libldmimg.so, and no module of the port
    names that library or that directory."""
    import pathlib
    import re

    code = (
        "import sys, os\n"
        f"native = os.path.join({REPO!r}, 'native')\n"
        "opened = []\n"
        "def hook(ev, args):\n"
        "    if ev == 'open' and isinstance(args[0], (str, bytes)):\n"
        "        opened.append(os.fsdecode(args[0]))\n"
        "sys.addaudithook(hook)\n"
        "from ldm_image_generator_tpu_torch.data import dataset\n"
        f"ds = dataset.ImageDataset([{imgs!r}], cache_dir={str(tmp_path / 'c')!r}, size=16)\n"
        "assert len(ds) == 6 and ds[0].shape == (16, 16, 3)\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad = [p for p in opened if os.path.abspath(p).startswith(native + os.sep)]\n"
        "assert not bad and 'libldmimg' not in maps, (bad, 'libldmimg' in maps)\n"
        "assert not any(m == 'ldm_image_generator_tpu' or m.startswith("
        "'ldm_image_generator_tpu.') for m in sys.modules)\n"
        "print('ok', ds.built)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr
    pattern = re.compile(r"libldmimg|(?<!\w)native/|[\"']native[\"']\s*[,)]")
    for path in (pathlib.Path(REPO) / "ldm_image_generator_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cpp"):
            assert not pattern.search(path.read_text()), str(path)
