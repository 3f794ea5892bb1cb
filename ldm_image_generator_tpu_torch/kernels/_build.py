"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Each ``kernels/csrc/<name>.cu`` compiles into its own shared library with
a plain C interface, ``build/torch_kernels/<name>-<hash>.so`` at the root
of the checkout, at first use. The hash covers every file in csrc and the
compiler flags, so editing a source rebuilds it and an unchanged tree
reuses the library. Nothing here runs at import: the CPU tests import
every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("block_core", "ffn_block", "ffn_block_bwd", "window_attention", "vq")
# dynamic shared memory one block may use on the H100
MAX_SMEM_BYTES = 227 * 1024

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_digest(files, flags) -> str:
    """A short hash of the compiler flags and of each file's name and
    bytes: the version a build of those sources is named by."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _digest() -> str:
    return source_digest(sorted(CSRC.iterdir()), NVCC_FLAGS)


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source (or None when its library is current)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(job) -> None:
    proc, tmp, out, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed ({rc}) for {out.name}:\n"
            + out.with_suffix(".log").read_text()[-4000:]
        )
    os.replace(tmp, out)


def build_all(names=SOURCES) -> float:
    """Compile every listed source at once (one nvcc each, in parallel).
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with _lock:
        jobs = [j for j in (_start(n, nvcc) for n in names) if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    last build of `name`, or '' when this process found it built."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# {source: {function: (argtypes, restype)}}
_SIGNATURES = {
    "block_core": {
        "block_core_forward": ([_I, _I, _P, _P, _P, _I] + [_P] * 12 + [_I, _P, _P, _P]
                               + [_I] * 6 + [_P] * 6, _I),
        "block_core_scratch_floats": ([_I] * 5, _LL),
        "block_core_smem_bytes": ([_I] * 6, _LL),
        "block_core_tensor_cores": ([_I] * 5, _I),
        "ffn_counter_ints": ([], _LL),
    },
    "ffn_block": {
        "ffn_tensor_cores": ([_I] * 4, _I),
        "ffn_wgmma_route": ([_I] * 5, _I),
        "ffn_block_forward": ([_I, _I, _P, _P, _P, _I] + [_P] * 12 + [_I, _P]
                              + [_I] * 3 + [_P] * 6, _I),
        "ffn_block_scratch_floats": ([_I] * 4, _LL),
        "ffn_counter_ints": ([], _LL),
    },
    "ffn_block_bwd": {
        "ffn_block_backward": ([_I] + [_P] * 12 + [_I, _P] + [_I] * 3
                               + [_P] * 6, _I),
        "ffn_bwd_grad_floats": ([_I] * 2, _LL),
        "ffn_bwd_scratch_floats": ([_I] * 4, _LL),
        "ffn_bwd_tensor_cores": ([_I] * 4, _I),
        "ffn_tensor_cores": ([_I] * 4, _I),
        "ffn_counter_ints": ([], _LL),
    },
    "window_attention": {
        "window_mha_tensor_cores": ([_I] * 4, _I),
        "window_mha_bwd_tensor_cores": ([_I] * 4, _I),
        "window_mha_forward": ([_I] + [_P] * 10 + [_I] * 4 + [_P] * 6, _I),
        "window_mha_smem_bytes": ([_I] * 4, _LL),
        "window_mha_scratch_floats": ([_I] * 5, _LL),
        "window_mha_counter_ints": ([], _LL),
        "window_mha_backward": ([_I] + [_P] * 10 + [_I] * 4 + [_P] * 9, _I),
        "window_mha_bwd_smem_bytes": ([_I] * 4, _LL),
        "window_mha_bwd_scratch_floats": ([_I] * 5, _LL),
    },
    "vq": {
        "vq_nearest": ([_I, _P, _P, _I, _I, _P, _P], _I),
        "vq_slice_codes": ([_I] * 2, _I),
    },
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    sigs = dict(_SIGNATURES[name], ldm_error_string=([_I], ctypes.c_char_p))
    for fn_name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.ldm_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def cuda_ptrs(*tensors: torch.Tensor) -> list:
    """data_ptr of each tensor, after checking it is a contiguous tensor
    on the current CUDA device."""
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"CUDA kernels take tensors on cuda:{dev}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernels take contiguous tensors")
    return [t.data_ptr() for t in tensors]


def current_stream() -> int:
    """The current CUDA stream of the current device, as a raw pointer
    (what torch.cuda.current_stream().cuda_stream gives, without
    building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
