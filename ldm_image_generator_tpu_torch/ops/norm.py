"""Channel normalization over the trailing (channel) axis of NHWC maps."""
from __future__ import annotations

import torch


def channel_norm(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """(x - mean) * rsqrt(var_unbiased + eps) over the last axis, with no
    affine. Statistics in fp32 whatever the input dtype; the result is
    cast back to x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
