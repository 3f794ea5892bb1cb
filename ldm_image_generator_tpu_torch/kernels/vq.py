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

On the H100 (csrc/vq.cu), in one launch: the dot runs on the tensor
cores (mma.sync m16n8k8 in TF32, k = D = 8), made fp32-accurate by
splitting each operand into a TF32 head and a TF32 tail and summing
head*head + head*tail + tail*head (a bf16 x is exactly a TF32 value, so
two passes); the accumulator starts at ||e||^2, so the score leaves the
tensor cores whole and the CUDA cores only keep a running (min score,
index) per row, strict < in code order. A thread-block cluster of up to
8 CTAs splits K; each CTA stages its slice of the codebook, split as it
loads, in shared memory, and writes its rows' minima into rank 0's
shared memory, which merges them in rank order, ties to the lower index.
No partials in device memory, no atomics: reruns are bitwise equal. The
bound is the least-cost fp32-accurate product on the tensor cores:
three TF32 passes for an fp32 x, three bf16 passes (the codebook split
in three bf16 pieces) for a bf16 x (workloads.FP32_PRODUCT).

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
# the kernel keeps code indices in fp32, exact up to 2**24
KERNEL_MAX_CODES = 1 << 24


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
    if k > KERNEL_MAX_CODES:
        raise ValueError(f"the vq kernel takes at most {KERNEL_MAX_CODES} codes, got {k}")
    code = _build.dtype_code(x)
    if codebook.data_ptr() % 16:
        raise ValueError("the vq kernel reads codebook rows as float4: its "
                         "data must be 16-byte aligned")
    lib = _build.load("vq")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    p = _build.cuda_ptrs(x, codebook, out)
    rc = lib.vq_nearest(code, p[0], p[1], n, k, p[2], _build.current_stream())
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
