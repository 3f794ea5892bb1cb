"""The VQ autoencoder and its discriminator (NHWC), the torch counterparts
of ldm_image_generator_tpu/models/vae.py.

Encoder: 1x1 input Dense -> per stage ResStack, then (between stages)
2x2 average pool + 1x1 Dense -> 1x1 to the latent channels (8x down at
the default config). Decoder: 1x1 input Dense -> per stage
[ConvTranspose(k=2, s=2) upsample (stages after the first)] -> ResStack
-> 1x1 to_rgb; the output is the progressive RGB pyramid sum, each level
bilinearly upsampled 2x onto the next. VectorQuantizer: a K x D codebook
used only as a training regularizer (the symmetric L1 commitment loss to
each latent's nearest code, found by the kernels/vq.py wrapper).
Discriminator: stride-`stem_size` conv stem -> per stage ResStack, a 1x1
early-exit head whose mean adds to the logit, and a 2x2 stride-2 conv
down between stages.

Compute dtype: `forward(..., dtype=...)` casts the input, and every
module casts its parameters at use to the activations' dtype, so fp32
parameters train in bf16 compute; by default the parameters' dtype (the
sampling pipeline casts its decoder once).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ldm_image_generator_tpu_torch.config import (
    DiscriminatorConfig,
    VAEConfig,
    resolve_device,
)
from ldm_image_generator_tpu_torch.kernels.vq import nearest_codebook_indices
from ldm_image_generator_tpu_torch.models.layers import Dense, ParamInit, cast
from ldm_image_generator_tpu_torch.models.unet import (
    StrideConv,
    StrideConvTranspose,
    avg_pool_2x,
)


class Conv3x3(nn.Module):
    """SAME 3x3 conv of NHWC maps with an HWIO kernel (flax nn.Conv)."""

    def __init__(self, cin: int, cout: int, init: ParamInit):
        super().__init__()
        self.kernel = init.lecun(3, 3, cin, cout, fan_in=9 * cin)
        self.bias = init.zeros(cout)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     cast(self.kernel, x.dtype).permute(3, 2, 0, 1),
                     cast(self.bias, x.dtype), padding=1)
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


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = ParamInit(resolve_device(device), generator)
        self.cfg = cfg
        chs = list(cfg.encoder_channels)
        self.input_layer = Dense(cfg.input_channels, chs[0], init)
        for i, (c, l) in enumerate(zip(chs, cfg.encoder_stages)):
            self.add_module(f"stage_{i}", ResStack(c, l, init))
            if i != len(chs) - 1:
                self.add_module(f"down_{i}", Dense(c, chs[i + 1], init))
        self.output_layer = Dense(chs[-1], cfg.latent_channels, init)

    @property
    def dtype(self) -> torch.dtype:
        return self.input_layer.kernel.dtype

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        """RGB in about [-1, 1], [B, H, W, 3] -> latents [B, H/8, W/8, 8],
        computed in dtype (default: the parameters')."""
        x = self.input_layer(x.to(dtype or self.dtype))
        n = len(self.cfg.encoder_channels)
        for i in range(n):
            x = getattr(self, f"stage_{i}")(x)
            if i != n - 1:
                x = getattr(self, f"down_{i}")(avg_pool_2x(x))
        return self.output_layer(x)


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

    def forward(self, z, dtype: Optional[torch.dtype] = None):
        """z [B, h, w, latent] -> RGB in about [-1, 1], [B, 8h, 8w, 3],
        computed in dtype (default: the parameters')."""
        x = self.input_layer(z.to(dtype or self.dtype))
        rgb_out = None
        for i in range(len(self.cfg.decoder_channels)):
            if i:
                x = getattr(self, f"up_{i}")(x)
            x, rgb = getattr(self, f"stage_{i}")(x)
            rgb_out = rgb if rgb_out is None else bilinear_up_2x(rgb_out) + rgb
        return rgb_out


class VectorQuantizer(nn.Module):
    """Learned codebook `embeddings` [K, D] (normal, std 1) with
    nearest-code assignment; its forward is the symmetric L1 commitment
    loss between latents and their (non-differentiable) nearest codes."""

    def __init__(self, num_embeddings: int = 8192, dim: int = 8, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = ParamInit(resolve_device(device), generator)
        self.embeddings = init.normal(num_embeddings, dim)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest code index per vector, x [..., D] -> int32 [...]
        (no gradient: both operands are detached)."""
        return nearest_codebook_indices(x.detach(), self.embeddings.detach())

    def embed(self, idx: torch.Tensor) -> torch.Tensor:
        """The codes at idx; the gradient reaches only those rows."""
        return F.embedding(idx, self.embeddings)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """mean |x - sg(e)| + mean |e - sg(x)| for e the nearest codes (a
        bf16 x meets the fp32 codes in fp32)."""
        e = self.embed(self.quantize(x))
        reg = (x - e.detach()).abs().mean()
        emb = (e - x.detach()).abs().mean()
        return reg + emb


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        init = ParamInit(resolve_device(device), generator)
        self.cfg = cfg
        chs = list(cfg.channels)
        self.input_layer = StrideConv(cfg.input_channels, chs[0], cfg.stem_size, init)
        for i, (c, l) in enumerate(zip(chs, cfg.stages)):
            self.add_module(f"stage_{i}", ResStack(c, l, init))
            self.add_module(f"early_exit_{i}", Dense(c, 1, init))
            if i != len(chs) - 1:
                self.add_module(f"down_{i}", StrideConv(c, chs[i + 1], 2, init))

    @property
    def dtype(self) -> torch.dtype:
        return self.input_layer.kernel.dtype

    def forward(self, x, features: bool = False,
                dtype: Optional[torch.dtype] = None):
        """The scalar logit: the sum over stages of the mean of the stage's
        1x1 head. With features=True also the stage maps (for
        feature_matching_loss)."""
        x = self.input_layer(x.to(dtype or self.dtype))
        n = len(self.cfg.channels)
        logit = 0.0
        feats = []
        for i in range(n):
            x = getattr(self, f"stage_{i}")(x)
            feats.append(x)
            logit = logit + getattr(self, f"early_exit_{i}")(x).mean()
            if i != n - 1:
                x = getattr(self, f"down_{i}")(x)
        return (logit, feats) if features else logit


def feature_matching_loss(feats_fake: Sequence[torch.Tensor],
                          feats_real: Sequence[torch.Tensor]) -> torch.Tensor:
    """L1 feature matching summed over the discriminator's stages."""
    loss = 0.0
    for f, r in zip(feats_fake, feats_real):
        loss = loss + (f - r.detach()).abs().mean()
    return loss


def vae_loss(encoder_apply: Callable, decoder_apply: Callable,
             quantizer_apply: Callable, x: torch.Tensor,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise_gain: float = 0.1,
             stripe: Optional[Tuple[int, slice]] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode, add standard normal noise (injected, or drawn from
    `generator` in the latents' dtype) times noise_gain, the VQ commitment
    loss on [B, HW, D] latents, decode, L1 reconstruction. Returns
    (recon, reg, y). stripe (global batch, rows): x holds those rows of
    a global batch (one data-parallel rank's), and the drawn noise is
    the global batch's, cut to them."""
    z = encoder_apply(x)
    if noise is None:
        shape = z.shape if stripe is None else (stripe[0],) + tuple(z.shape[1:])
        noise = torch.randn(shape, generator=generator, device=z.device,
                            dtype=z.dtype)
        if stripe is not None:
            noise = noise[stripe[1]]
    z = z + noise.to(z.dtype) * noise_gain
    b, h, w, d = z.shape
    reg = quantizer_apply(z.reshape(b, h * w, d))
    y = decoder_apply(z)
    recon = (x.detach() - y).abs().mean()
    return recon, reg, y


class VAE:
    """Encoder, decoder and quantizer together (the reference VAE class;
    its ``calclate_loss`` spelling is kept as an alias)."""

    def __init__(self, encoder: Encoder, decoder: Decoder,
                 quantizer: VectorQuantizer):
        self.encoder = encoder
        self.decoder = decoder
        self.quantizer = quantizer

    def calculate_loss(self, x, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       noise_gain: float = 0.1):
        """(recon, reg, y) of vae_loss."""
        return vae_loss(self.encoder, self.decoder, self.quantizer, x,
                        noise=noise, generator=generator, noise_gain=noise_gain)

    calclate_loss = calculate_loss

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)
