"""The native image decoder, bound with ctypes: the torch counterpart of
ldm_image_generator_tpu/data/native_loader.py.

data/csrc/image_pipeline.cpp (a copy of the JAX package's C++ pipeline:
libjpeg/libpng decode, aspect-preserving nearest resize, sigma-1 blur
when downscaling, centered black pad, x / 127.5 - 1) is compiled at first
use with g++ into build/torch_native/image_pipeline-<hash>.so at the root
of the checkout, the hash covering the source and the flags (written
under a temporary name and renamed, so processes building at once do not
race). ctypes releases the GIL for the call, so the batch API decodes on
a native thread pool while Python threads write the cache.

Where the library cannot be built (no g++, or no libjpeg/libpng headers)
available() is False, the compiler's first error line is printed once on
stderr, and the dataset takes its PIL path, as the JAX package documents.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ldm_image_generator_tpu_torch.kernels._build import source_digest

SOURCE = Path(__file__).resolve().parent / "csrc" / "image_pipeline.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-Wall"]
LINK = ["-ljpeg", "-lpng"]

_lock = threading.Lock()
# (library or None, why it is None) once a load was tried
_loaded: Optional[tuple] = None


def library_path() -> Path:
    return BUILD_DIR / f"image_pipeline-{source_digest([SOURCE], CXX_FLAGS + LINK)}.so"


def build() -> float:
    """Compile the library unless it is current: the seconds it took (0
    when current). Raises RuntimeError with the compiler's first error
    line when it cannot be built."""
    import time

    out = library_path()
    if out.exists():
        return 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = [ln for ln in res.stderr.splitlines() if "error" in ln] or \
            res.stderr.splitlines() or [f"g++ exited {res.returncode}"]
        raise RuntimeError(lines[0].strip())
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _load() -> Optional[ctypes.CDLL]:
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded[0]
        try:
            build()
            lib = ctypes.CDLL(str(library_path()))
        except (RuntimeError, OSError) as e:
            _loaded = (None, str(e))
            print(f"native image decoder unavailable, decoding with PIL: {e}",
                  file=sys.stderr, flush=True)
            return None
        lib.ldm_preprocess.restype = ctypes.c_int
        lib.ldm_preprocess.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.ldm_preprocess_batch.restype = ctypes.c_int
        lib.ldm_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _loaded = (lib, None)
        return lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None when it was)."""
    _load()
    return _loaded[1]


def preprocess_batch_native(paths, size: int, num_threads: int = 0,
                            out: Optional[np.ndarray] = None):
    """One native call for a batch of files (read, decode, resize, pad on
    a thread pool of num_threads, or one per core): (images float32 [n,
    size, size, 3], status int32 [n], 0 = ok; a failed slot is all -1),
    or None when the library is unavailable. `out` may supply the
    destination buffer."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    if out is None:
        out = np.empty((n, size, size, 3), dtype=np.float32)
    if out.shape != (n, size, size, 3) or out.dtype != np.float32 or \
            not out.flags.c_contiguous:
        raise ValueError(f"out: a C-contiguous float32 [{n}, {size}, {size}, 3] buffer")
    status = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.ldm_preprocess_batch(arr, n, size,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                             num_threads)
    return out, status


def preprocess_image_native(path, size: int) -> Optional[np.ndarray]:
    """float32 [size, size, 3] in [-1, 1] of the image at `path` (or in a
    binary file object, read to its end), or None when the library is
    unavailable, the file unreadable or its decode fails."""
    lib = _load()
    if lib is None:
        return None
    if hasattr(path, "read"):
        data = path.read()
    else:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
    out = np.empty((size, size, 3), dtype=np.float32)
    rc = lib.ldm_preprocess(data, len(data), size,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return None if rc != 0 else out
