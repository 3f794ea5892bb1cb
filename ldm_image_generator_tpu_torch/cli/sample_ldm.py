"""Sample images from the latent diffusion model on the GPU.

    python -m ldm_image_generator_tpu_torch.cli.sample_ldm -s 256 -n 1 \\
        -t 20 -fp16 true -o ./ddpm_outputs/ [--quant int8]

Builds seeded random weights (loading checkpoints is not ported yet),
runs DDIM sampling and writes <outdir>/<i>.png. --quant int8 samples
with per-output-column int8 FFN weights (UNetConfig.ffn_quant). Runs on
`cuda` unless `-d cpu` is given; a CUDA request without a card raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import zlib


def str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y", "t"):
        return True
    if v.lower() in ("false", "0", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def save_png(path: str, img) -> None:
    """Write a uint8 [H, W, 3] array as an 8-bit RGB PNG (stdlib only)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sample LDM (PyTorch/CUDA port)")
    p.add_argument("--config", default="default", choices=["default", "tiny"],
                   help="model size preset (tiny = test/debug scale)")
    p.add_argument("-s", "--size", default=512, type=int)
    p.add_argument("-n", "--numimages", default=1, type=int)
    p.add_argument("-t", "--timesteps", default=20, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--eta", default=0.0, type=float)
    p.add_argument("-fp16", default=False, type=str2bool,
                   help="bfloat16 compute (false: float32)")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: per-output-column quantized FFN weights")
    p.add_argument("-o", "--outdir", default="./ddpm_outputs/")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        UNetConfig,
        VAEConfig,
        resolve_device,
    )
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline

    device = resolve_device(args.device)
    ucfg, vcfg = UNetConfig(), VAEConfig()
    if args.config == "tiny":
        ucfg, vcfg = ucfg.tiny(), vcfg.tiny()
    ucfg = dataclasses.replace(ucfg, ffn_quant=args.quant)
    dtype = (DEFAULT_PRECISION if args.fp16 else FULL_PRECISION).compute_dtype
    pipe = LDMPipeline.random(ucfg, vcfg, dtype=dtype, device=device,
                              seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    imgs = pipe.sample(gen, batch=args.numimages, image_size=args.size,
                       num_steps=args.timesteps, eta=args.eta).cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    for i in range(args.numimages):
        save_png(os.path.join(args.outdir, f"{i}.png"), imgs[i])
    print(f"saved {args.numimages} images to {args.outdir}")


if __name__ == "__main__":
    main()
