"""Parameter files in the format the JAX package writes
(``flax.serialization.to_bytes``; ldm_image_generator_tpu/utils/
checkpoint.py ``save_params``), read and written without flax or msgpack.

The format is msgpack: nested maps with str keys whose leaves are
ext type 1 (an ndarray: the msgpack array (shape, dtype name, raw
C-order bytes)) or ext type 3 (a numpy scalar, packed as a 0-d ndarray).
A leaf over MAX_CHUNK_SIZE bytes is written as the map
{'__msgpack_chunked_array__': True, 'shape': {'0': d0, ...},
'chunks': {'0': flat ndarray, ...}}. Only what such files hold is
coded: maps, arrays, str, bin, ints, bool, those two ext types, and the
dtypes in DTYPES.

Leaves load as numpy arrays that view one buffer holding the file (no
copy per array); a bfloat16 leaf (numpy has no such type) loads as a
torch.bfloat16 tensor over its raw bytes. ``save_params`` takes numpy
arrays and torch tensors (bfloat16 included) and streams each array's
bytes to the file.

Full training states (``TrainCheckpointer``, for the trainers'
--ckpt-dir) are the port's own format: one directory per step holding a
torch.save file of plain dicts, lists and tensors, read back with
weights_only=True.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax/serialization.py: leaves over this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
DTYPES = ("float32", "float16", "bfloat16", "int8", "int32")


def _is_torch_file(head: bytes) -> bool:
    # torch.save >= 1.6 writes a zip ("PK..."); the legacy format a pickle
    return head.startswith(b"PK") or head[:1] == b"\x80"


class _Reader:
    """msgpack decoder over one buffer; arrays are views of it."""

    def __init__(self, buf):
        self.view = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.view):
            raise ValueError("truncated parameter file")
        return self.view[start:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8/16/32
        if b in sized:
            return self.take(self.unpack(sized[b]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one a parameter "
                         "file holds")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key if isinstance(key, str) else str(key)] = self.value()
        return out

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one a parameter "
                             "file holds")
        # the body is itself msgpack: [shape, dtype name, raw bytes]
        shape, name, raw = self.value()
        if self.pos != end:
            raise ValueError("malformed ndarray in the parameter file")
        name = name if isinstance(name, str) else str(name, "ascii")
        arr = _array(raw, name, tuple(shape))
        return arr[()] if code == EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr


def _array(raw: memoryview, name: str, shape: tuple):
    """A view of raw as an array of the named dtype and shape."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} is not one a parameter file holds")
    if name == "bfloat16":
        flat = np.frombuffer(raw, dtype=np.int16)
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Chunked leaves (flax's form for leaves over MAX_CHUNK_SIZE bytes)
    back into arrays; every other map walked."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_params(path: str, torch_converter=None) -> dict:
    """The nested tree of a parameter file written by the JAX package's
    save_params (or by save_params here). A PyTorch state_dict file (the
    reference's, told by its first bytes) goes through torch_converter
    (e.g. ``lambda sd: torch_import.convert_ddpm(sd, cfg)``), as the JAX
    package's load_params does; without one it raises."""
    with open(path, "rb") as f:
        head = f.read(8)
    if _is_torch_file(head):
        if torch_converter is None:
            raise ValueError(
                f"{path} is a PyTorch checkpoint; pass the matching "
                "utils.torch_import converter to load it")
        from ldm_image_generator_tpu_torch.utils.torch_import import load_state_dict

        return torch_converter(load_state_dict(path))
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    reader = _Reader(buf)
    tree = reader.value()
    if reader.pos != size:
        raise ValueError(f"{path}: {size - reader.pos} bytes after the tree")
    if not isinstance(tree, dict):
        raise ValueError(f"{path} does not hold a parameter tree")
    return _unchunk(tree)


# -- writing -------------------------------------------------------------


def _uint(n: int) -> bytes:
    if n <= 0x7F:
        return struct.pack(">B", n)
    for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                           (0xCE, ">I", 0xFFFFFFFF)):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _int(n: int) -> bytes:
    if n >= 0:
        return _uint(n)
    if n >= -32:
        return struct.pack(">b", n)
    for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                           (0xD2, ">i", -0x80000000)):
        if n >= low:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xd3" + struct.pack(">q", n)


def _sized(n: int, small, codes: tuple) -> bytes:
    """Header of a str / bin / array / map of n items: `small` (a fix
    form's first byte, or None) below its limit, else 8/16/32-bit."""
    if small is not None and n < small[1]:
        return bytes([small[0] | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items exceed msgpack's 32-bit length")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + data


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), (None, 0xDE, 0xDF))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), (None, 0xDC, 0xDD))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    for c, fmt, top in ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                        (0xC9, ">I", 0xFFFFFFFF)):
        if n <= top:
            return bytes([c]) + struct.pack(fmt, n) + struct.pack(">b", code)
    raise ValueError("an ndarray body over 4 GiB")


def _leaf(v):
    """(dtype name, shape, C-order raw bytes as a memoryview) of an array
    leaf, or None for a Python value."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), memoryview(t.view(torch.int16).numpy()).cast("B")
        v = t.numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        if a.dtype.name not in DTYPES:
            raise ValueError(f"dtype {a.dtype.name!r} is not one a parameter "
                             "file holds")
        # (np.ascontiguousarray would make a 0-d scalar 1-d)
        flat = np.ascontiguousarray(a.reshape(-1))
        return a.dtype.name, tuple(a.shape), memoryview(flat).cast("B")
    return None


def _chunked(v) -> dict:
    """flax's chunked form of an array leaf over MAX_CHUNK_SIZE bytes."""
    flat = v.detach().reshape(-1) if isinstance(v, torch.Tensor) else np.asarray(v).reshape(-1)
    size = flat.element_size() if isinstance(flat, torch.Tensor) else flat.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / size))
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(v.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _write(f, v) -> None:
    if isinstance(v, Mapping):
        f.write(_map_header(len(v)))
        for k, x in v.items():
            f.write(_str(str(k)))
            _write(f, x)
        return
    leaf = _leaf(v)
    if leaf is not None:
        name, shape, raw = leaf
        if raw.nbytes > MAX_CHUNK_SIZE and shape:
            _write(f, _chunked(v))
            return
        head = (_array_header(3) + _array_header(len(shape))
                + b"".join(_int(int(d)) for d in shape) + _str(name)
                + _sized(raw.nbytes, None, (0xC4, 0xC5, 0xC6)))
        code = EXT_NPSCALAR if isinstance(v, np.generic) else EXT_NDARRAY
        f.write(_ext_header(code, len(head) + raw.nbytes))
        f.write(head)
        f.write(raw)
        return
    if isinstance(v, bool):
        f.write(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        f.write(_int(v))
    else:
        raise TypeError(f"cannot write a {type(v).__name__} to a parameter file")


def save_params(path: str, tree: Mapping[str, Any]) -> None:
    """Write a nested {str: array or map} tree as the JAX package's
    save_params would (flax msgpack), atomically: a temporary file in the
    same directory, then os.replace."""
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            _write(f, tree)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


# -- training state ------------------------------------------------------

# the file of a step directory of TrainCheckpointer
STATE_FILE = "train_state.pt"
# what orbax (the JAX package's TrainCheckpointer) leaves in a directory
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "default")


def state_tree(obj):
    """A train state as torch.load(weights_only=True) reads it back: a
    module -> {parameter name: tensor}, a dataclass -> {field: ...},
    lists, dicts, tensors, ints and None as they are."""
    import dataclasses

    from torch import nn

    if isinstance(obj, nn.Module):
        return {n: p.detach() for n, p in obj.named_parameters()}
    if dataclasses.is_dataclass(obj):
        return {f.name: state_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [state_tree(v) for v in obj]
    if isinstance(obj, dict):
        return {k: state_tree(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (torch.Tensor, int)):
        return obj
    raise TypeError(f"a train state cannot hold a {type(obj).__name__}")


def load_state_tree(template, tree, where: str = "state"):
    """`template` (a train state built as the run builds it) with the
    values of `tree` (state_tree's form): tensors and parameters are
    copied in place, bitwise, on the template's device; ints are taken
    from the tree. Any difference of structure, name or shape
    raises."""
    import dataclasses

    from torch import nn

    if isinstance(template, nn.Module):
        params = dict(template.named_parameters())
        if not isinstance(tree, dict) or set(tree) != set(params):
            raise ValueError(f"{where}: the checkpoint's parameter names differ "
                             "from the model's")
        with torch.no_grad():
            for n, p in params.items():
                _copy_into(p, tree[n], f"{where}.{n}")
        return template
    if dataclasses.is_dataclass(template):
        names = [f.name for f in dataclasses.fields(template)]
        if not isinstance(tree, dict) or set(tree) != set(names):
            raise ValueError(f"{where}: the checkpoint holds another state")
        return dataclasses.replace(template, **{
            n: load_state_tree(getattr(template, n), tree[n], f"{where}.{n}")
            for n in names})
    if isinstance(template, list):
        if not isinstance(tree, list) or len(tree) != len(template):
            raise ValueError(f"{where}: the checkpoint's list differs in length")
        return [load_state_tree(t, v, f"{where}[{i}]")
                for i, (t, v) in enumerate(zip(template, tree))]
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"{where}: the checkpoint's keys differ")
        return {k: load_state_tree(template[k], tree[k], f"{where}.{k}")
                for k in template}
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            _copy_into(template, tree, where)
        return template
    if template is None or isinstance(template, int):
        if (template is None) != (tree is None):
            raise ValueError(f"{where}: None in one of the state and the checkpoint")
        return tree
    raise TypeError(f"{where}: a train state cannot hold a {type(template).__name__}")


def _copy_into(dst: torch.Tensor, src, where: str) -> None:
    if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
            or src.dtype != dst.dtype:
        raise ValueError(f"{where}: the checkpoint's tensor differs in shape or "
                         "dtype")
    dst.copy_(src)


class TrainCheckpointer:
    """Step-numbered training-state checkpoints in the port's own format
    (the JAX package keeps orbax directories; this package imports no
    orbax and resumes only from its own).

    directory/<step>/train_state.pt holds {"step", "state", "generators"}:
    the state as state_tree makes it (parameters, optimizer state, EMA),
    and the get_state() of each torch.Generator the run draws from. A step
    is written under a temporary name and renamed into place, so a crash
    leaves no half checkpoint that latest_step would pick; the oldest
    steps beyond max_to_keep are deleted after each save."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if name in ORBAX_MARKERS or (
                    name.isdigit() and not os.path.exists(
                        os.path.join(self.directory, name, STATE_FILE))):
                raise ValueError(
                    f"{self.directory} holds a checkpoint this package did not "
                    f"write ({name!r}; orbax writes such directories): the "
                    "PyTorch port resumes only from its own checkpoints")

    def steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state, generators=()) -> str:
        """Write `state` and the generators' states as step `step`
        (replacing an earlier checkpoint of that step); returns its
        directory."""
        import shutil

        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save({"step": int(step), "state": state_tree(state),
                            "generators": [g.get_state() for g in generators]}, f)
                f.flush()
                os.fsync(f.fileno())
            final = self.path(step)
            if os.path.exists(final):
                old = os.path.join(self.directory, f".old-{step}-{os.getpid()}")
                os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old)
            else:
                os.rename(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for old_step in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.path(old_step))
        return final

    def restore(self, state, generators=(), step=None, transform=None):
        """`state` (built as the run builds it) holding the checkpoint of
        `step` (default: the latest), with each generator's state set;
        None when the directory holds no checkpoint. transform(tree)
        maps the saved state tree first (a ZeRO-1 rank cuts the saved
        whole moments to its slices)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        data = torch.load(os.path.join(self.path(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
        if len(data["generators"]) != len(generators):
            raise ValueError(f"checkpoint {step} holds {len(data['generators'])} "
                             f"generator states, the run draws from {len(generators)}")
        tree = data["state"] if transform is None else transform(data["state"])
        state = load_state_tree(state, tree)
        for g, s in zip(generators, data["generators"]):
            g.set_state(s)
        return state
