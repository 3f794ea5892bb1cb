"""Images, or their latents encoded once, held in memory: the torch
counterparts of ImageDataset and LatentImageDataset in
ldm_image_generator_tpu/data/dataset.py.

The same files are found (`**/*.jpg` recursively and `*.png` at the top
of each source dir), in the same order, optionally cut to max_len, and
preprocessed as the JAX package's PIL path does (aspect-preserving
NEAREST resize, GaussianBlur(1) when downscaling, a centered black
square pad, x / 127.5 - 1 as float32). Images, or the latents the given
encoder makes of them in batches, are kept in memory as float16, as the
JAX package's cache stores them. Each dataset's `labels` give every
item's source-dir index. The content-addressed disk cache and the
native decoder are not ported yet.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, List, Sequence, Tuple

import numpy as np

# images per call of the encoder while the latents are built
ENCODE_BATCH = 16


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


def preprocess_image(path, size: int) -> np.ndarray:
    """Decode (a path or a binary file object) -> aspect-preserving
    NEAREST resize (+ blur when downscaling) -> centered black square pad
    -> float32 [size, size, 3] in [-1, 1]."""
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


class ImageDataset:
    """The preprocessed images under source_dirs, held in memory as
    float16 [len, size, size, 3] and served as float16 (the train step
    casts them to fp32 on its device, as the JAX step does)."""

    def __init__(self, source_dirs: Sequence[str], size: int = 512,
                 max_len: int = -1):
        self.paths, self.labels = _paths(source_dirs, max_len)
        self.size = size
        self.images = np.stack([preprocess_image(p, size).astype(np.float16)
                                for p in self.paths])

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> np.ndarray:
        return self.images[index]


def _paths(source_dirs: Sequence[str], max_len: int):
    """find_images' (paths, labels), both cut to max_len (> 0)."""
    paths, labels = find_images(source_dirs)
    if not paths:
        raise ValueError(f"no .jpg/.png images found under {list(source_dirs)}")
    if max_len and max_len > 0:
        return paths[:max_len], labels[:max_len]
    return paths, labels


class LatentImageDataset:
    """Latents of the images under source_dirs, encoded once by encode_fn
    (float32 NHWC images [b, size, size, 3] -> latents) in batches of
    ENCODE_BATCH and held in memory as float16 [len, h, w, c]."""

    def __init__(self, source_dirs: Sequence[str], encode_fn: Callable,
                 size: int = 512, max_len: int = -1):
        self.paths, self.labels = _paths(source_dirs, max_len)
        chunks = []
        for start in range(0, len(self.paths), ENCODE_BATCH):
            imgs = np.stack([preprocess_image(p, size)
                             for p in self.paths[start:start + ENCODE_BATCH]])
            chunks.append(np.asarray(encode_fn(imgs), dtype=np.float16))
        self.latents = np.concatenate(chunks)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> np.ndarray:
        return self.latents[index].astype(np.float32)
