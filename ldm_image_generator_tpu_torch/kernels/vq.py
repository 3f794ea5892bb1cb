"""Nearest-codebook search of the VectorQuantizer.

Replaces ``nearest_codebook_indices_pallas`` (ldm_image_generator_tpu/
kernels/vq.py:56, body ``_vq_kernel``): for each of N vectors x[N, D]
the int32 argmin over the K codebook rows e[K, D] of

    score[n, k] = ||e_k||^2 - 2 x_n . e_k

in fp32 (||x_n||^2 is constant along a row and dropped), the first index
on ties, as jnp.argmin and torch.argmin give. x is fp32 or bf16 and is
read as fp32; the codebook is fp32. Only the indices leave the card: the
plain version writes the [N, K] score matrix to device memory and reads
it back (151 MB at the VAE train step), the kernel keeps every score in
registers.

On the H100 (csrc/vq.cu): the work is N * K * (2D + 2) fp32 operations
on a few hundred KB, so the kernel is bound by the CUDA cores' fp32 rate.
Each thread keeps four rows of x in registers; each block streams a
slice of the codebook through shared memory in chunks and keeps a
running (min score, index) per row with a strict <, so the lowest index
wins within a slice. The K axis is split over blocks so that the card
has a few blocks per SM at N = 4608; the slices' (min, index) partials
meet in a second pass that takes them in slice order with the same
strict <, so ties still go to the first index. No atomics: reruns are
bitwise equal.

There is no backward: the indices are integers and the quantizer stops
gradients through them (models/vae.py).
"""
from __future__ import annotations

import torch

from ldm_image_generator_tpu_torch.kernels import _build

# calls of nearest_codebook_indices that launched the CUDA kernel
launches = 0
# the kernel's vector width (VAEConfig.embedding_dim)
KERNEL_DIM = 8


def nearest_codebook_indices_plain(x: torch.Tensor,
                                   codebook: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [N, D], codebook [K, D] -> int32 [N]
    (nearest_codebook_indices_xla in the JAX package)."""
    e = codebook.float()
    e_sq = (e * e).sum(-1)
    return torch.argmin(e_sq[None] - 2.0 * (x.float() @ e.T), dim=-1).int()


def _launch(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    k = codebook.shape[0]
    if d != KERNEL_DIM or codebook.shape[1] != d:
        raise ValueError(f"the vq kernel takes D={KERNEL_DIM}, got x "
                         f"{tuple(x.shape)} and codebook {tuple(codebook.shape)}")
    if codebook.dtype != torch.float32:
        raise TypeError(f"the vq kernel takes a float32 codebook, got {codebook.dtype}")
    code = _build.dtype_code(x)
    if codebook.data_ptr() % 16:
        raise ValueError("the vq kernel reads codebook rows as float4: its "
                         "data must be 16-byte aligned")
    lib = _build.load("vq")
    splits = lib.vq_splits(n, k)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    part_min = torch.empty((splits, n), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=x.device)
    p = _build.cuda_ptrs(x, codebook, out, part_min, part_idx)
    rc = lib.vq_nearest(code, p[0], p[1], n, k, splits, p[2], p[3], p[4],
                        _build.current_stream())
    _build.check(lib, rc, "vq")
    global launches
    launches += 1
    return out


def nearest_codebook_indices(x: torch.Tensor,
                             codebook: torch.Tensor) -> torch.Tensor:
    """x [..., D], codebook [K, D] -> int32 [...]: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (or an exception)."""
    shape = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        return nearest_codebook_indices_plain(flat, codebook).reshape(shape)
    return _launch(flat, codebook).reshape(shape)
