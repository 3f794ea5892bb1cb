"""Convert parameter files between the reference's PyTorch state_dicts
and flax msgpack, the port's counterpart of the JAX package's
cli/convert.py (its flags; no flax: the msgpack side goes through
utils/checkpoint.py, whose output is the JAX tool's byte for byte).

The trainers and samplers already convert torch files at their
parameter paths; this tool does it explicitly:

    python -m ldm_image_generator_tpu_torch.cli.convert ddpm.pt --kind ddpm -o ddpm.ckpt
    python -m ldm_image_generator_tpu_torch.cli.convert vae_encoder.pt --kind encoder

and back, a reference state_dict that the reference codebase loads with
strict load_state_dict:

    python -m ldm_image_generator_tpu_torch.cli.convert ddpm.ckpt --kind ddpm --to-torch
"""
from __future__ import annotations

import argparse
import os

KINDS = ("encoder", "decoder", "quantizer", "discriminator", "unet", "ddpm")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert checkpoints: torch state_dict <-> msgpack params "
                    "(PyTorch port)")
    p.add_argument("input", help="torch .pt state_dict or msgpack .ckpt file")
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("-o", "--output", default=None,
                   help="output path (default: <input>.ckpt, or <input>.pt "
                        "with --to-torch)")
    p.add_argument("--config", default="default", choices=["default", "tiny"])
    p.add_argument("--to-torch", action="store_true",
                   help="reverse direction: msgpack params -> reference "
                        "torch state_dict (utils/torch_export.py)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ldm_image_generator_tpu_torch.config import (
        DiscriminatorConfig,
        UNetConfig,
        VAEConfig,
    )
    from ldm_image_generator_tpu_torch.convert import flatten_tree
    from ldm_image_generator_tpu_torch.utils.checkpoint import (
        _is_torch_file,
        load_params,
        save_params,
    )

    vcfg = VAEConfig() if args.config == "default" else VAEConfig().tiny()
    ucfg = UNetConfig() if args.config == "default" else UNetConfig().tiny()
    dcfg = DiscriminatorConfig()

    if args.to_torch:
        from ldm_image_generator_tpu_torch.utils import torch_export as te

        with open(args.input, "rb") as f:
            if _is_torch_file(f.read(8)):
                raise SystemExit(f"{args.input} is already a torch checkpoint")
        params = load_params(args.input)
        exporters = {
            "encoder": lambda: te.export_encoder(params, vcfg),
            "decoder": lambda: te.export_decoder(params, vcfg),
            "quantizer": lambda: te.export_quantizer(params),
            "discriminator": lambda: te.export_discriminator(params, dcfg),
            "unet": lambda: te.export_unet(params, ucfg),
            "ddpm": lambda: te.export_ddpm(params, ucfg),
        }
        sd = exporters[args.kind]()
        out = args.output or os.path.splitext(args.input)[0] + ".pt"
        te.save_state_dict(out, sd)
        n = sum(int(v.size) for v in sd.values())
        print(f"exported {args.input} ({args.kind}, {n/1e6:.2f}M params) "
              f"-> {out} [torch state_dict, {len(sd)} entries]")
        return

    from ldm_image_generator_tpu_torch.utils import torch_import as ti

    sd = ti.load_state_dict(args.input)
    converters = {
        "encoder": lambda: ti.convert_encoder(sd, vcfg),
        "decoder": lambda: ti.convert_decoder(sd, vcfg),
        "quantizer": lambda: ti.convert_quantizer(sd),
        "discriminator": lambda: ti.convert_discriminator(sd, dcfg),
        "unet": lambda: ti.convert_unet(sd, ucfg),
        "ddpm": lambda: ti.convert_ddpm(sd, ucfg),
    }
    params = converters[args.kind]()
    out = args.output or os.path.splitext(args.input)[0] + ".ckpt"
    save_params(out, params)
    n = sum(int(v.size) for v in flatten_tree(params).values())
    print(f"converted {args.input} ({args.kind}, {n/1e6:.2f}M params) -> {out}")


if __name__ == "__main__":
    main()
