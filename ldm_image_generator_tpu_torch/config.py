"""Config dataclasses, field for field with ldm_image_generator_tpu.config.

UNetConfig, VAEConfig and DDPMConfig carry the same defaults and
``tiny()`` presets as the JAX package; Precision uses torch dtypes.
Options of the JAX configs whose code paths are not ported (the XLA
backends) keep their fields so
the two trees compare equal; the port rejects non-default values where
it would otherwise ignore them (models/unet.py ``refusal``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Denoiser UNet (defaults: 385.7M params, 4 stages)."""

    input_channels: int = 8
    stages: Sequence[int] = (3, 3, 9, 3)
    channels: Sequence[int] = (128, 256, 512, 1024)
    stem_size: int = 1
    head_dim: int = 32
    window_size: int = 6
    num_experts: int = 4
    experts_per_call: int = 2
    ffn_mul: int = 1
    stochastic_depth: float = 0.25
    # deterministic MoE routing for parity tests; None = a random
    # 2-of-num_experts pair per block per call
    fixed_expert_indices: "tuple | None" = None
    ablate_branches: "tuple | None" = None
    attention_backend: str = "auto"
    ffn_backend: str = "auto"
    remat: bool = False
    ffn_quant: str = "none"
    num_classes: int = 0
    cond_channels: int = 256
    cond_tokens: int = 4

    def tiny(self) -> "UNetConfig":
        return dataclasses.replace(
            self, stages=(1, 1), channels=(32, 64), input_channels=self.input_channels
        )

    def tiny_deep(self) -> "UNetConfig":
        """Tiny preset with a deep (pipelinable) first stack, the test and
        debug scale of --pipeline-stages (a stack pipelines only when its
        homogeneous prefix divides into the stages)."""
        return dataclasses.replace(
            self, stages=(2, 1), channels=(32, 64), input_channels=self.input_channels
        )


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Diffusion transformer (facebookresearch/DiT ``DiT``; the fields are
    its constructor's). Defaults: DiT-XL/2 at 512px, a 64x64x4 latent."""

    input_size: int = 64
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True

    @property
    def input_channels(self) -> int:
        """The latent's channels (the name the pipelines ask the UNet's
        config for)."""
        return self.in_channels

    @property
    def out_channels(self) -> int:
        """The eps prediction, then with learn_sigma as many variance
        channels."""
        return self.in_channels * (2 if self.learn_sigma else 1)

    @staticmethod
    def xl_2(input_size: int = 64) -> "DiTConfig":
        """DiT-XL/2 (models.py ``DiT_XL_2``) on an input_size^2 latent."""
        return DiTConfig(input_size=input_size, patch_size=2, hidden_size=1152,
                         depth=28, num_heads=16)

    def tiny(self) -> "DiTConfig":
        return dataclasses.replace(self, input_size=8, hidden_size=64, depth=2,
                                   num_heads=4, num_classes=10)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """VQ autoencoder."""

    input_channels: int = 3
    latent_channels: int = 8
    encoder_channels: Sequence[int] = (64, 128, 256, 512)
    encoder_stages: Sequence[int] = (2, 2, 2, 2)
    decoder_channels: Sequence[int] = (512, 256, 128, 64)
    decoder_stages: Sequence[int] = (2, 2, 2, 2)
    num_embeddings: int = 8192
    embedding_dim: int = 8

    @property
    def downscale(self) -> int:
        # one 2x down between consecutive encoder stages
        return 2 ** (len(self.encoder_channels) - 1)

    def tiny(self) -> "VAEConfig":
        return dataclasses.replace(
            self,
            encoder_channels=(16, 32),
            encoder_stages=(1, 1),
            decoder_channels=(32, 16),
            decoder_stages=(1, 1),
            num_embeddings=64,
        )


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """Multi-scale conv discriminator of the VAE trainer."""

    input_channels: int = 3
    channels: Sequence[int] = (32, 48, 48, 96)
    stages: Sequence[int] = (2, 2, 2, 2)
    stem_size: int = 1


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    """Diffusion schedule and loss."""

    beta_min: float = 1e-4
    beta_max: float = 0.02
    num_timesteps: int = 1000
    loss: str = "l1"
    lambda_max: float = 20.0
    lambda_min: float = -20.0
    prediction: str = "eps"
    zero_terminal_snr: bool = False


@dataclasses.dataclass(frozen=True)
class Precision:
    """Compute dtype for activations and the cast weights; fp32 params."""

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def full() -> "Precision":
        return Precision(compute_dtype=torch.float32)


DEFAULT_PRECISION = Precision()
FULL_PRECISION = Precision.full()


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA request without a card
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
