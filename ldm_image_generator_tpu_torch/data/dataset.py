"""Images, or their latents encoded once, in a content-addressed disk
cache: the torch counterparts of ImageDataset and LatentImageDataset in
ldm_image_generator_tpu/data/dataset.py.

The same files are found (`**/*.jpg` recursively and `*.png` at the top
of each source dir), in the same order, optionally cut to max_len, and
preprocessed as the JAX package does (aspect-preserving NEAREST resize,
GaussianBlur(1) when downscaling, a centered black square pad, x / 127.5
- 1 as float32): by the native decoder (data/native_loader.py) where it
builds, else by PIL. Each item is written once as an fp16 .npy file under
cache_dir, named by the sha1 of `path|mtime_ns|file size|image size|1|
kind` (the JAX package's key, kind `img` or `lat`) and written atomically
(a temporary name, then os.replace), so a run reuses what an earlier run
of either package built and concurrent runs do not clobber each other.
The latent key also names the encoder (encoder_fingerprint, a hash of its
parameters' bytes): a retrained encoder gets fresh latents, where the JAX
package's key would serve the stale ones; so a latent cache is not shared
with the JAX package.

Items are served from the cache: load_raw as a read-only memory map of
the fp16 file (what the loader stacks from), __getitem__ as float32; a
file that fails to load falls back to item 0. Each dataset's `labels`
give every item's source-dir index; `built` counts how the last build
decoded (native, pil, and native rejects that PIL decoded).
"""
from __future__ import annotations

import glob
import hashlib
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_image_generator_tpu_torch.data import native_loader

_PIPELINE_VERSION = "1"
# images per native batch call of the cache build
NATIVE_CHUNK = 64


def find_images(source_dirs: Sequence[str]) -> Tuple[List[str], List[int]]:
    """(paths, labels): the .jpg files under each dir (recursively) and
    its top-level .png files, dir by dir; labels[i] is the index of the
    dir paths[i] came from (the class id of dir-per-class conditioning)."""
    paths: List[str] = []
    labels: List[int] = []
    for di, d in enumerate(source_dirs):
        found = glob.glob(os.path.join(d, "**/*.jpg"), recursive=True)
        found += glob.glob(os.path.join(d, "*.png"))
        paths += found
        labels += [di] * len(found)
    return paths, labels


def preprocess_image(path, size: int, use_native: bool = True) -> np.ndarray:
    """Decode (a path or a binary file object) -> aspect-preserving
    NEAREST resize (+ blur when downscaling) -> centered black square pad
    -> float32 [size, size, 3] in [-1, 1]: the native decoder where it
    builds and takes the file, else PIL."""
    if use_native:
        start = path.tell() if hasattr(path, "seek") else None
        arr = native_loader.preprocess_image_native(path, size)
        if arr is not None:
            return arr
        if start is not None:
            path.seek(start)
    from PIL import Image, ImageFile, ImageFilter

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    img = Image.open(path).convert("RGB")
    w0, h0 = img.size
    if w0 > h0:
        w, h = size, max(1, int(h0 * size / w0))
    else:
        w, h = max(1, int(w0 * size / h0)), size
    downscaling = w0 > w or h0 > h
    img = img.resize((w, h), Image.NEAREST)
    if downscaling:
        img = img.filter(ImageFilter.GaussianBlur(1))
    canvas = Image.new("RGB", (size, size), (0, 0, 0))
    canvas.paste(img, ((size - w) // 2, (size - h) // 2))
    return np.asarray(canvas, dtype=np.float32) / 127.5 - 1.0


def module_fingerprint(module) -> str:
    """A sha1 of a module's parameter names, shapes, dtypes and bytes (the
    latent cache's name for its encoder)."""
    h = hashlib.sha1()
    for name, p in module.state_dict().items():
        t = p.detach().cpu().contiguous()
        h.update(f"{name}|{tuple(t.shape)}|{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _write_atomic(cache_path: str, arr: np.ndarray) -> None:
    tmp = cache_path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:  # a file object: np.save appends no .npy
        np.save(f, arr)
    os.replace(tmp, cache_path)


class ImageDataset:
    """Preprocessed square images in the cache, served as float32 NHWC
    arrays [size, size, 3]. n_workers: threads of the build (-1 or 0:
    one per core)."""

    def __init__(self, source_dirs: Sequence[str], cache_dir: str = "./dataset_cache/",
                 size: int = 8, max_len: int = -1, n_workers: int = -1):
        self.source_dirs = list(source_dirs)
        self.cache_dir = cache_dir
        self.size = size
        self.n_workers = n_workers
        self.paths, self.labels = find_images(source_dirs)
        if not self.paths:
            raise ValueError(f"no .jpg/.png images found under {list(source_dirs)}")
        if max_len and max_len > 0:
            self.paths = self.paths[:max_len]
            self.labels = self.labels[:max_len]
        os.makedirs(cache_dir, exist_ok=True)
        self._cache_paths = [self._cache_path(p) for p in self.paths]
        self.built = dict(native=0, pil=0, fallback=0)
        self._build_cache()

    def set_size(self, size: int) -> None:
        """Re-target the dataset to another image size: the keys of that
        size, building only the items missing there (switching back
        builds nothing)."""
        if size == self.size:
            return
        self.size = size
        self._cache_paths = [self._cache_path(p) for p in self.paths]
        self._build_cache()

    # -- cache ------------------------------------------------------------
    def _kind(self) -> str:
        return "img"

    def _cache_key(self, path: str) -> str:
        try:
            st = os.stat(path)
            sig = f"{path}|{st.st_mtime_ns}|{st.st_size}"
        except OSError:
            sig = path
        sig += f"|{self.size}|{_PIPELINE_VERSION}|{self._kind()}"
        return hashlib.sha1(sig.encode()).hexdigest()

    def _cache_path(self, path: str) -> str:
        return os.path.join(self.cache_dir, self._cache_key(path) + ".npy")

    def _missing(self) -> List[int]:
        return [i for i, c in enumerate(self._cache_paths) if not os.path.exists(c)]

    def _threads(self) -> int:
        if self.n_workers in (-1, 0):
            return os.cpu_count() or 1
        return self.n_workers

    def _build_one(self, i: int) -> None:
        """PIL's decode of item i into the cache (a file it cannot read
        is left out: loading it falls back to item 0)."""
        try:
            arr = preprocess_image(self.paths[i], self.size, use_native=False)
        except Exception as e:  # noqa: BLE001 - any unreadable image
            print(f"cannot decode {self.paths[i]}: {e}", file=sys.stderr)
            return
        _write_atomic(self._cache_paths[i], arr.astype(np.float16))

    def _build_cache(self) -> None:
        self.built = dict(native=0, pil=0, fallback=0)
        missing = self._missing()
        if not missing:
            return
        if self._build_cache_native(missing):
            if self.built["fallback"]:
                print(f"cache build: {self.built['fallback']} of {len(missing)} images "
                      "rejected by the native decoder, decoded with PIL", flush=True)
            return
        with ThreadPoolExecutor(self._threads()) as pool:
            for f in [pool.submit(self._build_one, i) for i in missing]:
                f.result()
        self.built["pil"] = len(missing)

    def _build_cache_native(self, missing: List[int]) -> bool:
        """The build through the native batch API: one call per chunk of
        NATIVE_CHUNK images (file reads and decodes on its thread pool,
        the GIL released), into two reused buffers, chunk k's fp16 writes
        on a writer thread while chunk k + 1 decodes into the other
        buffer. An image the decoder rejects goes to PIL on its own.
        False when the library is unavailable."""
        if not native_loader.available():
            return False
        threads = 0 if self.n_workers in (-1, 0) else self.n_workers
        n0 = min(NATIVE_CHUNK, len(missing))
        bufs = [np.empty((n0, self.size, self.size, 3), np.float32) for _ in range(2)]

        def write_chunk(idxs, imgs, status):
            for j, i in enumerate(idxs):
                if status[j] == 0:
                    _write_atomic(self._cache_paths[i], imgs[j].astype(np.float16))
                else:
                    self._build_one(i)
                    self.built["fallback"] += 1

        with ThreadPoolExecutor(1, thread_name_prefix="ldm-cache-write") as writer:
            pending = None
            for ci, start in enumerate(range(0, len(missing), NATIVE_CHUNK)):
                idxs = missing[start:start + NATIVE_CHUNK]
                imgs, status = native_loader.preprocess_batch_native(
                    [self.paths[i] for i in idxs], self.size, threads,
                    out=bufs[ci % 2][:len(idxs)])
                if pending is not None:
                    pending.result()  # the other buffer is free again
                pending = writer.submit(write_chunk, idxs, imgs, status)
            if pending is not None:
                pending.result()
        self.built["native"] = len(missing) - self.built["fallback"]
        return True

    # -- access -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.paths)

    def load_raw(self, index: int) -> np.ndarray:
        """The cached fp16 array as a read-only memory map (item 0's when
        this one fails to load)."""
        try:
            return np.load(self._cache_paths[index], mmap_mode="r")
        except (OSError, ValueError):
            return np.load(self._cache_paths[0], mmap_mode="r")

    def __getitem__(self, index: int) -> np.ndarray:
        return self.load_raw(index).astype(np.float32)

    def cache_line(self) -> str:
        """What the last build did, for the trainers' log."""
        b = self.built
        return (f"cache {self.cache_dir}: {sum(b.values())} of {len(self)} decoded "
                f"(native {b['native']}, pil {b['pil']}, native rejects to pil "
                f"{b['fallback']})")


class LatentImageDataset(ImageDataset):
    """Images pushed through a frozen encoder once, cached and served as
    latents. encode_fn maps a float32 NHWC image batch [encode_batch,
    size, size, 3] to latents (a tail batch is padded with zero images
    to that shape); encoder_fingerprint (module_fingerprint of the
    encoder) joins the cache key. `encoded` counts encode_fn's calls in
    the last build."""

    def __init__(self, source_dirs: Sequence[str], cache_dir: str = "./dataset_cache/",
                 size: int = 512, max_len: int = -1,
                 encode_fn: Optional[Callable] = None, encode_batch: int = 16,
                 n_workers: int = -1, encoder_fingerprint: Optional[str] = None):
        self.encode_fn = encode_fn or (lambda x: x)
        self.encode_batch = encode_batch
        self.encoder_fingerprint = encoder_fingerprint
        self.encoded = 0
        super().__init__(source_dirs, cache_dir, size, max_len, n_workers)

    def cache_line(self) -> str:
        return (f"latent cache {self.cache_dir}: {self.encoded} encoder calls "
                f"(batches of {self.encode_batch})")

    def _kind(self) -> str:
        if self.encoder_fingerprint:
            return f"lat|{self.encoder_fingerprint}"
        return "lat"

    def _build_cache(self) -> None:
        self.built = dict(native=0, pil=0, fallback=0)
        self.encoded = 0
        missing = self._missing()
        bs = self.encode_batch
        for start in range(0, len(missing), bs):
            idxs = missing[start:start + bs]
            imgs = np.stack([preprocess_image(self.paths[i], self.size) for i in idxs])
            pad = bs - len(idxs)
            if pad:
                imgs = np.concatenate([imgs, np.zeros_like(imgs[:1]).repeat(pad, 0)])
            z = np.asarray(self.encode_fn(imgs))[:len(idxs)]
            self.encoded += 1
            for j, i in enumerate(idxs):
                _write_atomic(self._cache_paths[i], z[j].astype(np.float16))
