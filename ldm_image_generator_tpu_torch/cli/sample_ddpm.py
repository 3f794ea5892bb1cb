"""Sample from the pixel-space DDPM.

    python -m ldm_image_generator_tpu_torch.cli.sample_ddpm -dp ddpm.pt \\
        -s 32 -n 10 -t 20 -o ./ddpm_outputs/

The flags and defaults of the JAX package's cli/sample_ddpm.py, plus
-d cuda|cpu. -dp names the UNet's parameter file (flax msgpack as the
trainers write it, or the reference's torch state_dict, converted); a
path that does not exist means seeded random weights, and a file of
another model config exits with the JAX CLI's message. Image i is drawn
alone (batch 1) from a generator seeded with --seed + i, by DDIM or
--sampler dpm++2m, optionally with DeepCache (--cache-interval N > 1),
and written as <outdir>/<i>.png (the JAX CLI writes JPEG; the card
machines have no PIL, so the stdlib PNG writer of cli/sample_ldm is
used). Runs on `cuda` unless `-d cpu` is given; a CUDA request without a
card raises. The JAX CLI's launch flags (--coordinator, --process-id,
--num-processes) form a process group, as its setup_device does; each
process then samples on its own card, cuda:(rank % device_count).
"""
from __future__ import annotations

import argparse
import os

from ldm_image_generator_tpu_torch.cli.common import add_diffusion_args, add_launch_args
from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load, save_png, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sample pixel-space DDPM "
                                            "(PyTorch/CUDA port)")
    p.add_argument("-dp", "--ddpmpath", default="./ddpm.pt")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    add_launch_args(p)
    p.add_argument("-fp16", default=True, type=str2bool,
                   help="bfloat16 compute (false: float32)")
    p.add_argument("-s", "--size", default=32, type=int)
    p.add_argument("-n", "--numimages", default=10, type=int)
    p.add_argument("-t", "--timesteps", default=20, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--eta", default=0.0, type=float)
    p.add_argument("--cache-interval", default=1, type=int,
                   help="DeepCache: recompute the UNet's deep core every N "
                        "sampler steps and reuse it in between (1 = off)")
    p.add_argument("--sampler", default="ddim", choices=["ddim", "dpm++2m"])
    p.add_argument("-o", "--outdir", default="./ddpm_outputs/")
    p.add_argument("--config", default="default", choices=["default", "tiny"],
                   help="model size preset (tiny = test/debug scale)")
    add_diffusion_args(p)
    return p


def build_pipeline(args):
    """The DDPMPipeline of the CLI's args: the 3-channel UNet seeded with
    --seed, then the -dp file where it exists."""
    import torch

    from ldm_image_generator_tpu_torch.cli.common import setup_device
    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DDPMConfig,
        UNetConfig,
    )
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.pipelines import DDPMPipeline
    from ldm_image_generator_tpu_torch.utils import torch_import as ti

    device = setup_device(args)[0]
    ucfg = UNetConfig(input_channels=3)
    if args.config == "tiny":
        ucfg = ucfg.tiny()
    dtype = (DEFAULT_PRECISION if args.fp16 else FULL_PRECISION).compute_dtype
    dcfg = DDPMConfig(prediction=args.prediction, zero_terminal_snr=args.zero_snr)
    unet = UNet(ucfg, device=device,
                generator=torch.Generator(device=device).manual_seed(args.seed))
    maybe_load(unet, args.ddpmpath, lambda sd: ti.convert_ddpm(sd, ucfg))
    return DDPMPipeline(unet, dcfg, dtype=dtype)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    pipe = build_pipeline(args)
    os.makedirs(args.outdir, exist_ok=True)
    for i in range(args.numimages):
        gen = torch.Generator(device=pipe.device).manual_seed(args.seed + i)
        img = pipe.sample(gen, batch=1, image_size=args.size,
                          num_steps=args.timesteps, eta=args.eta,
                          sampler=args.sampler, cache_interval=args.cache_interval)
        save_png(os.path.join(args.outdir, f"{i}.png"), img[0].cpu().numpy())
    print(f"saved {args.numimages} images to {args.outdir}")


if __name__ == "__main__":
    main()
