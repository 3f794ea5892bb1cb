"""VAE decoder (NHWC), the torch counterpart of the Decoder path of
ldm_image_generator_tpu/models/vae.py.

Decoder: 1x1 input Dense -> per stage [ConvTranspose(k=2, s=2) upsample
(stages after the first)] -> ResStack -> 1x1 to_rgb; the output is the
progressive RGB pyramid sum, each level bilinearly upsampled 2x onto the
next. The Encoder, the quantizer and the discriminator are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ldm_image_generator_tpu_torch.config import VAEConfig, resolve_device
from ldm_image_generator_tpu_torch.models.layers import Dense, ParamInit
from ldm_image_generator_tpu_torch.models.unet import StrideConvTranspose


class Conv3x3(nn.Module):
    """SAME 3x3 conv of NHWC maps with an HWIO kernel (flax nn.Conv)."""

    def __init__(self, cin: int, cout: int, init: ParamInit):
        super().__init__()
        self.kernel = init.lecun(3, 3, cin, cout, fan_in=9 * cin)
        self.bias = init.zeros(cout)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.permute(3, 2, 0, 1),
                     self.bias, padding=1)
        return y.permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    def __init__(self, channels: int, init: ParamInit):
        super().__init__()
        self.c1 = Conv3x3(channels, channels, init)
        self.c2 = Conv3x3(channels, channels, init)

    def forward(self, x):
        y = F.leaky_relu(self.c1(x), 0.01)
        return F.leaky_relu(self.c2(y), 0.01) + x


class ResStack(nn.Module):
    def __init__(self, channels: int, num_layers: int, init: ParamInit):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"res_{i}", ResBlock(channels, init))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"res_{i}")(x)
        return x


class DecoderStack(nn.Module):
    def __init__(self, channels: int, num_layers: int, output_channels: int,
                 init: ParamInit):
        super().__init__()
        self.layers = ResStack(channels, num_layers, init)
        self.to_rgb = Dense(channels, output_channels, init)

    def forward(self, x):
        x = self.layers(x)
        return x, self.to_rgb(x)


def bilinear_up_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres (align_corners=False;
    matches jax.image.resize 'bilinear' at the borders too)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = ParamInit(resolve_device(device), generator)
        self.cfg = cfg
        chs = list(cfg.decoder_channels)
        self.input_layer = Dense(cfg.latent_channels, chs[0], init)
        for i, (c, l) in enumerate(zip(chs, cfg.decoder_stages)):
            if i:
                self.add_module(f"up_{i}", StrideConvTranspose(chs[i - 1], c, 2, init))
            self.add_module(f"stage_{i}", DecoderStack(c, l, cfg.input_channels, init))

    @property
    def dtype(self) -> torch.dtype:
        return self.input_layer.kernel.dtype

    def forward(self, z):
        """z [B, h, w, latent] -> RGB in about [-1, 1], [B, 8h, 8w, 3]."""
        x = self.input_layer(z.to(self.dtype))
        rgb_out = None
        for i in range(len(self.cfg.decoder_channels)):
            if i:
                x = getattr(self, f"up_{i}")(x)
            x, rgb = getattr(self, f"stage_{i}")(x)
            rgb_out = rgb if rgb_out is None else bilinear_up_2x(rgb_out) + rgb
        return rgb_out
