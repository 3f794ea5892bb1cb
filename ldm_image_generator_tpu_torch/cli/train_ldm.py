"""Train the latent diffusion UNet on frozen-encoder latents.

    python -m ldm_image_generator_tpu_torch.cli.train_ldm imgs/ \\
        -s 256 -b 8 -e 1 -fp16 true

The flags are those of the JAX package's cli/train_ldm.py that this port
covers. The images are encoded once by the VAE Encoder of the -ep
parameter file (seeded random weights where it does not exist), the
UNet starts from the -mp file where it exists (else seeded random
weights), and each step is AdamW on the eps-prediction L1 loss
(optionally v-prediction, Min-SNR weighting, gradient clipping, an LR
schedule, accumulation over -bm steps and an EMA). The loss is printed
every step; at the end (also after an interrupt) the UNet is written to
-mp and the EMA to -mp + ".ema", flax parameter files as the JAX
package's. Runs on `cuda` unless `-d cpu` is given; a CUDA request
without a card raises.
"""
from __future__ import annotations

import argparse

from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train Latent Diffusion Model "
                                            "(PyTorch/CUDA port)")
    p.add_argument("dataset_path", nargs="+")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("-e", "--epoch", default=1, type=int)
    p.add_argument("-b", "--batch", default=1, type=int)
    p.add_argument("-mp", "--modelpath", default="./ddpm.pt")
    p.add_argument("-ep", "--encpath", default="./vae_encoder.pt")
    p.add_argument("-fp16", default=False, type=str2bool,
                   help="bfloat16 compute (false: float32); params stay fp32")
    p.add_argument("-s", "--size", default=512, type=int)
    p.add_argument("-m", "--maxdata", default=-1, type=int)
    p.add_argument("-lr", "--learningrate", default=1e-4, type=float)
    p.add_argument("-bm", "--batch_multiply", default=1, type=int)
    p.add_argument("--config", default="default", choices=["default", "tiny"],
                   help="model size preset (tiny = test/debug scale)")
    p.add_argument("--prediction", default="eps", choices=["eps", "v"])
    p.add_argument("--zero-snr", action="store_true",
                   help="zero terminal SNR schedule; needs --prediction v")
    p.add_argument("--ema", default=0.0, type=float, metavar="DECAY",
                   help="keep an EMA of the UNet params (e.g. 0.999)")
    p.add_argument("--grad-clip", default=0.0, type=float, metavar="NORM",
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--warmup-steps", default=0, type=int, metavar="STEPS")
    p.add_argument("--total-steps", default=0, type=int, metavar="STEPS")
    p.add_argument("--min-snr-gamma", default=0.0, type=float,
                   help="Min-SNR loss weighting gamma (0 = uniform)")
    # flags of the JAX trainer whose paths are not ported: refused below
    p.add_argument("--num-classes", default=0, type=int)
    p.add_argument("--pipeline-stages", default=0, type=int)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--fused-steps", default=1, type=int)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--val-dir", default=None, nargs="+")
    return p


def refusal(args):
    """The message refusing an option this port does not run yet, naming
    the ROADMAP item that brings it, or None."""
    todo = [
        (args.num_classes != 0, "--num-classes",
         "A16 (class-conditional training)"),
        (args.pipeline_stages != 0, "--pipeline-stages", "A13 (parallelism)"),
        (args.zero1, "--zero1", "A13 (parallelism)"),
        (args.fused_steps > 1, "--fused-steps > 1", "A7 (fused train steps)"),
        (args.ckpt_dir is not None, "--ckpt-dir", "A7 (resume)"),
        (args.val_dir is not None, "--val-dir", "A7 (the validator)"),
    ]
    for hit, flag, item in todo:
        if hit:
            return f"{flag} is not ported yet: ROADMAP {item}"
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    why = refusal(args)
    if why:
        raise SystemExit(why)
    import torch

    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DDPMConfig,
        UNetConfig,
        VAEConfig,
        resolve_device,
    )
    from ldm_image_generator_tpu_torch.convert import save_flax_file
    from ldm_image_generator_tpu_torch.data.dataset import LatentImageDataset
    from ldm_image_generator_tpu_torch.data.loader import BatchLoader
    from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.models.vae import Encoder
    from ldm_image_generator_tpu_torch.train.steps import (
        LDMTrainState,
        init_ema,
        make_ldm_train_step,
        make_optimizer,
    )

    device = resolve_device(args.device)
    ucfg, vcfg = UNetConfig(), VAEConfig()
    if args.config == "tiny":
        ucfg, vcfg = ucfg.tiny(), vcfg.tiny()
    dtype = (DEFAULT_PRECISION if args.fp16 else FULL_PRECISION).compute_dtype
    gen = torch.Generator(device=device).manual_seed(0)

    encoder = Encoder(vcfg, device=device, generator=gen)
    maybe_load(encoder, args.encpath)

    @torch.no_grad()
    def encode(imgs):
        return encoder(torch.from_numpy(imgs).to(device)).float().cpu().numpy()

    ds = LatentImageDataset(args.dataset_path, encode, size=args.size,
                            max_len=args.maxdata)
    print(f"dataset: {len(ds)} latents "
          f"({args.size // vcfg.downscale}px, {vcfg.latent_channels}ch)")
    del encoder

    unet = UNet(ucfg, device=device, generator=gen)
    maybe_load(unet, args.modelpath)
    schedule = make_schedule(DDPMConfig(prediction=args.prediction,
                                        zero_terminal_snr=args.zero_snr))
    tx = make_optimizer("adamw", args.learningrate,
                        accumulate=args.batch_multiply,
                        grad_clip=args.grad_clip, lr_schedule=args.lr_schedule,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.total_steps)
    state = LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                          ema_params=init_ema(unet) if args.ema > 0 else None)
    step_fn = make_ldm_train_step(
        unet, schedule, tx, prediction=args.prediction,
        ema_decay=args.ema if args.ema > 0 else None,
        min_snr_gamma=args.min_snr_gamma if args.min_snr_gamma > 0 else None,
        dtype=dtype)
    loader = BatchLoader(ds, args.batch)
    try:
        for epoch in range(args.epoch):
            print(f"Epoch #{epoch}")
            for batch in loader:
                state, metrics = step_fn(state, torch.from_numpy(batch).to(device),
                                         generator=gen)
                print(f"step {state.step} loss {metrics['loss'].item():.6f}")
    finally:
        save_flax_file(unet, args.modelpath)
        saved = [args.modelpath]
        if state.ema_params is not None:
            save_flax_file(state.ema_params, args.modelpath + ".ema")
            saved.append(args.modelpath + ".ema")
        print("saved " + ", ".join(saved))
    return state


if __name__ == "__main__":
    main()
