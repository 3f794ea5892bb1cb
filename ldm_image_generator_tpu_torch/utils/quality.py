"""Sample-quality metric: patched Kernel Inception Distance on VAE encoder
features ("patched KID", inception-free), the torch counterpart of
ldm_image_generator_tpu/utils/quality.py.

    images -> VAE Encoder -> latent maps [B, h, w, C]
           -> non-overlapping p x p patches -> features [B*n, p*p*C]
    KID = unbiased MMD^2 with the polynomial kernel k(x, y) = (x.y/d + 1)^3

(Binkowski et al. 2018, arXiv:1801.01401). Each image contributes n
patches, so the estimator works at small sample counts; it is a relative
metric (compare runs of the same encoder and patch size; lower is better;
independent draws of one distribution give about 0).

``random_conv_features`` is the VAE-independent feature path: a fixed
3-layer stride-2 conv net over pixels. Its weights are the JAX package's
He-scaled draws from jax.random.normal(fold_in(PRNGKey(0xC0FFEE), i)),
which torch cannot reproduce, so they ship as random_conv_weights.npz
beside this module (w0 [3, 3, 3, 16], w1 [3, 3, 16, 32], w2 [3, 3, 32,
64], HWIO float32), read with numpy.

Randomness is explicit: ``kid_mean_std`` draws its subsets from a
torch.Generator, and ``kid_subsets`` takes the subset indices themselves.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "random_conv_weights.npz")
# {device: [HWIO float32 tensors]} of random_conv_features
_weights: dict = {}


def patch_features(latents: torch.Tensor, patch: int = 4) -> torch.Tensor:
    """Latent maps [B, h, w, C] -> per-patch features [B*n, patch*patch*C]
    (non-overlapping patches; rows and columns that do not fill a patch
    are dropped)."""
    b, h, w, c = latents.shape
    p = min(patch, h, w)
    hh, ww = (h // p) * p, (w // p) * p
    x = latents[:, :hh, :ww, :].reshape(b, hh // p, p, ww // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b * (hh // p) * (ww // p), p * p * c)


def conv_weights(device) -> list:
    """The three HWIO weight tensors of random_conv_features on `device`."""
    key = str(torch.device(device))
    if key not in _weights:
        with np.load(WEIGHTS) as f:
            _weights[key] = [torch.from_numpy(f[f"w{i}"]).to(device) for i in range(3)]
    return _weights[key]


def _conv_same_stride2(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """XLA's SAME 3x3 convolution at stride 2 of NHWC x with an HWIO
    kernel: out = ceil(in / 2), the padding (out - 1) * 2 + 3 - in split
    with the smaller half before (an even side pads only after)."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad takes the last axis first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    y = F.pad(x.permute(0, 3, 1, 2), pads)
    return F.conv2d(y, kernel.permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)


def random_conv_features(images: torch.Tensor, patch: int = 4) -> torch.Tensor:
    """Per-patch features [B*n, patch*patch*64] of RGB images [B, H, W, 3]
    in [-1, 1] (NHWC, computed in fp32): three SAME 3x3 stride-2 convs
    (16, 32, 64 channels, no bias) each followed by leaky ReLU 0.2, then
    patch_features."""
    if images.shape[-1] != 3:
        raise ValueError(f"random_conv_features takes RGB images, not "
                         f"{images.shape[-1]} channels (its weights are for 3)")
    x = images.float()
    for w in conv_weights(images.device):
        x = F.leaky_relu(_conv_same_stride2(x, w), 0.2)
    return patch_features(x, patch)


def _poly_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.shape[-1]
    return (a @ b.T / d + 1.0) ** 3


def kid(feats_real: torch.Tensor, feats_fake: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD^2 with the degree-3 polynomial kernel (KID,
    arXiv:1801.01401 eq. 3) of [N, D] and [M, D] features, N, M >= 2,
    jointly standardized (the union's mean and standard deviation, ddof
    0, plus 1e-6), in fp32. A scalar tensor."""
    x, y = feats_real.float(), feats_fake.float()
    both = torch.cat([x, y], dim=0)
    mu = both.mean(dim=0, keepdim=True)
    sd = both.std(dim=0, correction=0, keepdim=True) + 1e-6
    x, y = (x - mu) / sd, (y - mu) / sd
    n, m = x.shape[0], y.shape[0]
    sum_off = lambda k, l: (k.sum() - k.diagonal().sum()) / (l * (l - 1))
    return (sum_off(_poly_kernel(x, x), n) + sum_off(_poly_kernel(y, y), m)
            - 2.0 * _poly_kernel(x, y).mean())


def kid_from_images(encoder, real_images: torch.Tensor, fake_images: torch.Tensor,
                    patch: int = 4, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """KID between two NHWC image sets in [-1, 1], features from `encoder`
    (a VAE Encoder of this package, frozen; computed in `dtype`, default
    its parameters') as fp32 patch features."""
    with torch.no_grad():
        feats = lambda imgs: patch_features(encoder(imgs, dtype=dtype).float(), patch)
        return kid(feats(real_images), feats(fake_images))


def kid_subsets(feats_real: torch.Tensor, feats_fake: torch.Tensor,
                idx_real: torch.Tensor, idx_fake: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std with ddof 0) of kid over the subsets given as index rows
    idx_real [S, s] and idx_fake [S, s]."""
    vals = torch.stack([kid(feats_real[ir], feats_fake[if_])
                        for ir, if_ in zip(idx_real, idx_fake)])
    return vals.mean(), vals.std(correction=0)


def kid_mean_std(feats_real: torch.Tensor, feats_fake: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 num_subsets: int = 10, subset_size: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KID reporting protocol (arXiv:1801.01401 sec. 5): mean and std
    of kid over num_subsets random subsets of each set, drawn without
    replacement from `generator` (real, then fake, per subset), of
    subset_size (0: min(N, M) // 2, at least 2)."""
    n = min(feats_real.shape[0], feats_fake.shape[0])
    s = subset_size or max(2, n // 2)
    dev = generator.device if generator is not None else feats_real.device
    draw = lambda total: torch.randperm(total, generator=generator, device=dev)[:s]
    rows = [(draw(feats_real.shape[0]), draw(feats_fake.shape[0]))
            for _ in range(num_subsets)]
    idx = lambda j, t: torch.stack([r[j] for r in rows]).to(t.device)
    return kid_subsets(feats_real, feats_fake, idx(0, feats_real), idx(1, feats_fake))
