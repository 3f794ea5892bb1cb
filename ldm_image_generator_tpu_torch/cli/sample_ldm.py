"""Sample images from the latent diffusion model on the GPU.

    python -m ldm_image_generator_tpu_torch.cli.sample_ldm -s 256 -n 1 \\
        -t 20 -fp16 true -dp ddpm.pt -decp vae_decoder.pt -o ./ddpm_outputs/

The flags of the JAX package's cli/sample_ldm.py, checked in its order.
-dp / -decp name the UNet and VAE decoder parameter files the trainers
write (flax msgpack, as the JAX package's) or the reference's torch
state_dict files (converted on load); a path that does not exist
means seeded random weights, and a file of another model config exits
with the JAX CLI's message. --sampler ddim | dpm++2m; --cache-interval
N > 1 (DeepCache); --num-classes with --class-id, --guidance-scale,
--negative-class and --cfg-rescale for class-conditional models;
--prediction and --zero-snr select the schedule; --quant int8 samples
with per-output-column int8 FFN weights (UNetConfig.ffn_quant).
--config dit-xl-2 (dit-tiny: its test scale) samples a DiT in the
UNet's place, class-conditional with DiTConfig's classes unless
--num-classes is given, on a 4-channel latent of -s / 8 (-s / 2 tiny);
-dp is then a DiT state_dict file (facebookresearch/DiT's), loaded
with strict=True where it exists. Writes
<outdir>/<i>.png. --init-image (with -encp the VAE encoder's file and
--strength) samples img2img from that image, tiled over -n; --mask (a
grayscale image, white = regenerate, black = keep) inpaints, DDIM only.
Runs on `cuda` unless `-d cpu` is given; a CUDA request without a card
raises. The JAX CLI's launch flags (--coordinator, --process-id,
--num-processes) form a process group, as its setup_device does; each
process then samples on its own card, cuda:(rank % device_count).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import zlib

from ldm_image_generator_tpu_torch.cli.common import add_diffusion_args, add_launch_args

# --config's presets: the UNet's, then the DiT's
CONFIGS = ["default", "tiny", "dit-xl-2", "dit-tiny"]


def dit_config(name: str, latent: int = 64, num_classes: int = 0):
    """The DiTConfig of a --config dit-* preset at a latent side, with
    num_classes where it is > 0 (else the preset's)."""
    from ldm_image_generator_tpu_torch.config import DiTConfig

    cfg = DiTConfig.xl_2() if name == "dit-xl-2" else DiTConfig().tiny()
    return dataclasses.replace(cfg, input_size=latent,
                               num_classes=num_classes if num_classes > 0
                               else cfg.num_classes)


def str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y", "t"):
        return True
    if v.lower() in ("false", "0", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def png_bytes(img) -> bytes:
    """A uint8 [H, W, 3] array as an 8-bit RGB PNG file's bytes (stdlib
    only)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    return b"".join((b"\x89PNG\r\n\x1a\n",
                     chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
                     chunk(b"IDAT", zlib.compress(raw)), chunk(b"IEND", b"")))


def save_png(path: str, img) -> None:
    """Write a uint8 [H, W, 3] array as an 8-bit RGB PNG (stdlib only)."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Sample LDM (PyTorch/CUDA port)")
    p.add_argument("-dp", "--ddpmpath", default="./ddpm.pt")
    p.add_argument("-decp", "--decpath", default="./vae_decoder.pt")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    add_launch_args(p)
    p.add_argument("-fp16", default=False, type=str2bool,
                   help="bfloat16 compute (false: float32)")
    p.add_argument("-s", "--size", default=512, type=int)
    p.add_argument("-n", "--numimages", default=1, type=int)
    p.add_argument("-t", "--timesteps", default=20, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--eta", default=0.0, type=float)
    p.add_argument("--cache-interval", default=1, type=int,
                   help="DeepCache: recompute the UNet's deep core every N "
                        "sampler steps and reuse it in between (1 = off; "
                        "not with guidance)")
    p.add_argument("--sampler", default="ddim", choices=["ddim", "dpm++2m"])
    p.add_argument("-o", "--outdir", default="./ddpm_outputs/")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the per-step DDIM sigma schedule")
    p.add_argument("--config", default="default", choices=CONFIGS,
                   help="model size preset (tiny = test/debug scale; dit-xl-2: "
                        "DiT-XL/2, dit-tiny its test scale)")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: per-output-column quantized FFN weights")
    p.add_argument("--num-classes", default=0, type=int,
                   help="class count the model was trained with; required "
                        "for --class-id")
    p.add_argument("--class-id", default=None, type=int)
    p.add_argument("--guidance-scale", default=1.0, type=float,
                   help="classifier-free guidance strength (1 = off)")
    p.add_argument("--negative-class", default=None, type=int,
                   help="condition the guidance baseline on this class "
                        "instead of the null class")
    p.add_argument("--cfg-rescale", default=0.0, type=float,
                   help="guidance rescale phi (0 = off)")
    add_diffusion_args(p)
    p.add_argument("--init-image", default=None,
                   help="img2img: start from this image (encoded, diffused to "
                        "--strength of the schedule, then denoised)")
    p.add_argument("-encp", "--encpath", default="./vae_encoder.pt",
                   help="VAE encoder parameter file (img2img only)")
    p.add_argument("--strength", default=0.6, type=float,
                   help="img2img: fraction of the forward process applied (0..1]")
    p.add_argument("--mask", default=None,
                   help="inpainting: grayscale mask image, white regenerated, "
                        "black kept (needs --init-image and the ddim sampler)")
    return p


def check_args(args) -> None:
    """The JAX CLI's argument checks, in its order, then its pipeline's
    img2img checks (here before any model is built). A DiT preset takes
    its own class count where --num-classes is not given."""
    if args.config.startswith("dit"):
        if args.quant != "none":
            raise SystemExit("--quant int8 quantizes a UNet's FFN weights; a DiT has none")
        args.num_classes = dit_config(args.config, num_classes=args.num_classes).num_classes
    if args.mask is not None and args.init_image is None:
        raise SystemExit("--mask requires --init-image")
    if args.class_id is not None and args.num_classes <= 0:
        raise SystemExit("--class-id requires --num-classes > 0")
    if args.negative_class is not None:
        if args.class_id is None:
            raise SystemExit("--negative-class requires --class-id")
        if args.guidance_scale == 1.0:
            raise SystemExit("--negative-class has no effect at --guidance-scale 1.0")
        if not 0 <= args.negative_class < args.num_classes:
            raise SystemExit(f"--negative-class must be in [0, {args.num_classes})")
    if args.init_image is not None:
        if not 0.0 < args.strength <= 1.0:
            raise SystemExit(f"strength must be in (0, 1], got {args.strength}")
        if args.mask is not None and args.sampler != "ddim":
            raise SystemExit("inpainting (mask=) requires sampler='ddim'")


def maybe_load(module, path: str, torch_converter=None) -> bool:
    """Load a parameter file into `module` if `path` exists (else leave
    its seeded weights): flax msgpack, or the reference's torch
    state_dict through torch_converter (a utils.torch_import converter,
    as the JAX CLI passes at that path). A file of another model config
    exits with the JAX CLI's message."""
    if not os.path.exists(path):
        return False
    from ldm_image_generator_tpu_torch.convert import load_flax_file

    try:
        load_flax_file(module, path, torch_converter)
    except (KeyError, ValueError) as e:
        raise SystemExit(e.args[0]) from e
    print(f"Loaded checkpoint: {path}")
    return True


def read_image(path: str, size: int, n: int, device):
    """The image at `path` preprocessed as the trainers' data (float32 in
    [-1, 1]), tiled to [n, size, size, 3] on `device`."""
    import torch

    from ldm_image_generator_tpu_torch.data.dataset import preprocess_image

    img = torch.from_numpy(preprocess_image(path, size))
    return img[None].repeat(n, 1, 1, 1).to(device)


def read_mask(path, size: int, n: int, device):
    """The grayscale mask at `path` (None: no mask), NEAREST-resized to
    size x size, as float32 [n, size, size, 1] in [0, 1] on `device`."""
    if path is None:
        return None
    import numpy as np
    import torch
    from PIL import Image

    m = Image.open(path).convert("L").resize((size, size), Image.NEAREST)
    m = torch.from_numpy(np.asarray(m, dtype=np.float32) / 255.0)
    return m[None, :, :, None].repeat(n, 1, 1, 1).to(device)


def build_pipeline(args, seed: int, with_encoder: bool):
    """The LDMPipeline of a sampling CLI's args (--config, --quant,
    --num-classes, -fp16, --prediction, --zero-snr, -d, and -s for a
    DiT's latent): weights seeded with `seed` (the denoiser, then the
    decoder, then the encoder when with_encoder), each followed by its
    parameter file (-dp, -decp, -encp) where it exists."""
    import torch

    from ldm_image_generator_tpu_torch.cli.common import setup_device
    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DDPMConfig,
        UNetConfig,
        VAEConfig,
    )
    from ldm_image_generator_tpu_torch.models.dit import DiT
    from ldm_image_generator_tpu_torch.models.vae import Decoder, Encoder
    from ldm_image_generator_tpu_torch.pipelines import LDMPipeline
    from ldm_image_generator_tpu_torch.utils import torch_import as ti

    device = setup_device(args)[0]
    ucfg, vcfg = UNetConfig(), VAEConfig()
    if args.config in ("tiny", "dit-tiny"):
        ucfg, vcfg = ucfg.tiny(), vcfg.tiny()
    dtype = (DEFAULT_PRECISION if args.fp16 else FULL_PRECISION).compute_dtype
    dcfg = DDPMConfig(prediction=args.prediction, zero_terminal_snr=args.zero_snr)
    gen = torch.Generator(device=device).manual_seed(seed)
    if args.config.startswith("dit"):
        # DiT's latent: 4 channels (its KL-f8's), decoded by the VQ Decoder
        vcfg = dataclasses.replace(vcfg, latent_channels=4, embedding_dim=4)
        cfg = dit_config(args.config, args.size // vcfg.downscale, args.num_classes)
        denoiser = DiT(cfg, device=device, generator=gen)
        load_dit_file(denoiser, args.ddpmpath)
    else:
        denoiser = unet_with_file(args, ucfg, device, gen)
    decoder = Decoder(vcfg, device=device, generator=gen)
    maybe_load(decoder, args.decpath, lambda sd: ti.convert_decoder(sd, vcfg))
    encoder = None
    if with_encoder:
        encoder = Encoder(vcfg, device=device, generator=gen)
        maybe_load(encoder, args.encpath, lambda sd: ti.convert_encoder(sd, vcfg))
    return LDMPipeline(denoiser, decoder, dcfg, dtype=dtype, encoder=encoder)


def unet_with_file(args, ucfg, device, gen):
    """The UNet of --quant and --num-classes, seeded from `gen`, then -dp's
    file where it exists."""
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.utils import torch_import as ti

    ucfg = dataclasses.replace(ucfg, ffn_quant=args.quant,
                               num_classes=max(args.num_classes, 0))
    # seeded weights as LDMPipeline.random makes them, then the file
    unet = UNet(ucfg, device=device, generator=gen)
    maybe_load(unet, args.ddpmpath, lambda sd: ti.convert_ddpm(sd, ucfg))
    return unet


def load_dit_file(dit, path: str) -> bool:
    """Load a DiT state_dict file (facebookresearch/DiT's, or torch.save of
    the module's state_dict) into `dit` with strict=True if `path`
    exists; a file of another shape exits with torch's message."""
    if not os.path.exists(path):
        return False
    import torch

    try:
        sd = torch.load(path, map_location=dit.pos_embed.device, weights_only=True)
        dit.load_state_dict(sd, strict=True)
    except (RuntimeError, OSError) as e:
        raise SystemExit(f"{path}: not a state_dict of this DiT config: {e}") from e
    print(f"Loaded checkpoint: {path}")
    return True


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_args(args)
    import torch

    pipe = build_pipeline(args, args.seed, args.init_image is not None)
    device = pipe.device
    full = lambda v: None if v is None else torch.full(
        (args.numimages,), v, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    guidance = dict(condition=full(args.class_id), guidance_scale=args.guidance_scale,
                    cfg_rescale=args.cfg_rescale,
                    negative_condition=full(args.negative_class))
    if args.init_image is not None:
        imgs = pipe.img2img(
            read_image(args.init_image, args.size, args.numimages, device), gen,
            strength=args.strength, num_steps=args.timesteps, eta=args.eta,
            sampler=args.sampler, mask=read_mask(args.mask, args.size, args.numimages,
                                                 device),
            **guidance)
    else:
        imgs = pipe.sample(gen, batch=args.numimages, image_size=args.size,
                           num_steps=args.timesteps, eta=args.eta,
                           sampler=args.sampler, cache_interval=args.cache_interval,
                           **guidance)
    imgs = imgs.cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    for i in range(args.numimages):
        save_png(os.path.join(args.outdir, f"{i}.png"), imgs[i])
    if args.verbose and args.sampler == "ddim":
        import numpy as np

        from ldm_image_generator_tpu_torch.diffusion.ddpm import ddim_step_pairs

        abar = pipe.schedule.alpha_bar.astype(np.float64)
        ts, ts_next = ddim_step_pairs(pipe.schedule.num_timesteps, args.timesteps)
        for t, tn in zip(ts, ts_next):
            a_t, a_n = abar[t], abar[tn]
            sigma = (args.eta * np.sqrt((1.0 - a_n) / (1.0 - a_t))
                     * np.sqrt(max(1.0 - a_t / a_n, 0.0)))
            print(f"step t={int(t):4d} -> {int(tn):4d}  sigma={sigma:.4f}")
    print(f"saved {args.numimages} images to {args.outdir}")


if __name__ == "__main__":
    main()
