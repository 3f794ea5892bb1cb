"""Train the pixel-space DDPM on images.

    python -m ldm_image_generator_tpu_torch.cli.train_ddpm imgs/ \\
        -s 32 -b 16 -e 3000 -fp16 true

The flags and defaults of the JAX package's cli/train_ddpm.py, plus
-d cuda|cpu. The UNet is the default config with input_channels=3 (or
its tiny preset), started from the -mp file where it exists (flax
msgpack, or the reference's torch state_dict, converted; else seeded
random weights), and each step is RAdam on the eps-prediction L1 loss
of the images themselves (optionally v-prediction and zero terminal
SNR, Min-SNR weighting, gradient clipping, an LR schedule and an EMA).
--ckpt-dir resumes from the latest full training state there,
--val-dir evaluates the stratified validation loss every --val-every
steps, and the run loop (cli/train_ldm.train_loop) writes JSON metric
lines every 10 steps, checks them for NaN/Inf every 50 and saves -mp
(and the EMA to -mp + ".ema") every --save-every batches and at the end,
also after an interrupt or a SIGTERM. Runs on `cuda` unless `-d cpu` is
given; a CUDA request without a card raises. --coordinator HOST:PORT
--process-id r --num-processes N (each process the same command) trains
data-parallel, as train_ldm does: -b is the global batch, the gradients
are all-reduced, rank 0 writes the files. The images are decoded once
into the content-addressed fp16 cache under ./dataset_cache/
(data/dataset.py) and read back from it on later runs.
"""
from __future__ import annotations

import argparse

from ldm_image_generator_tpu_torch.cli.common import add_diffusion_args, add_launch_args
from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train pixel-space DDPM "
                                            "(PyTorch/CUDA port)")
    p.add_argument("dataset_path", nargs="+")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    add_launch_args(p)
    p.add_argument("-e", "--epoch", default=3000, type=int)
    p.add_argument("-b", "--batch", default=16, type=int)
    p.add_argument("-mp", "--modelpath", default="./ddpm.pt")
    p.add_argument("-fp16", default=True, type=str2bool,
                   help="bfloat16 compute (false: float32); params stay fp32")
    p.add_argument("-s", "--size", default=32, type=int)
    p.add_argument("-m", "--maxdata", default=1000, type=int)
    p.add_argument("-lr", "--learningrate", default=1e-4, type=float)
    p.add_argument("--save-every", default=300, type=int)
    p.add_argument("--ckpt-dir", default=None,
                   help="full training-state checkpoints (resume from the "
                        "latest step there)")
    p.add_argument("--min-snr-gamma", default=0.0, type=float,
                   help="Min-SNR loss weighting gamma (0 = uniform)")
    p.add_argument("--config", default="default", choices=["default", "tiny"],
                   help="model size preset (tiny = test/debug scale)")
    add_diffusion_args(p, train=True)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ldm_image_generator_tpu_torch.cli.common import setup_device
    from ldm_image_generator_tpu_torch.cli.train_ldm import (
        data_parallel,
        resume,
        saver,
        train_loop,
    )
    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DDPMConfig,
        UNetConfig,
    )
    from ldm_image_generator_tpu_torch.data.dataset import ImageDataset
    from ldm_image_generator_tpu_torch.data.loader import BatchLoader
    from ldm_image_generator_tpu_torch.diffusion.ddpm import make_schedule
    from ldm_image_generator_tpu_torch.models.unet import UNet
    from ldm_image_generator_tpu_torch.train.steps import (
        LDMTrainState,
        init_ema,
        make_ldm_train_step,
        make_optimizer,
    )
    from ldm_image_generator_tpu_torch.utils import torch_import as ti

    device = setup_device(args)[0]
    dp = data_parallel(device)
    ucfg = UNetConfig(input_channels=3)
    if args.config == "tiny":
        ucfg = ucfg.tiny()
    dtype = (DEFAULT_PRECISION if args.fp16 else FULL_PRECISION).compute_dtype

    ds = ImageDataset(args.dataset_path, size=args.size, max_len=args.maxdata)
    print(f"dataset: {len(ds)} images at {args.size}px")
    print(ds.cache_line())

    gen = torch.Generator(device=device).manual_seed(0)
    unet = UNet(ucfg, device=device, generator=gen)
    maybe_load(unet, args.modelpath, lambda sd: ti.convert_ddpm(sd, ucfg))
    schedule = make_schedule(DDPMConfig(prediction=args.prediction,
                                        zero_terminal_snr=args.zero_snr))
    tx = make_optimizer("radam", args.learningrate, grad_clip=args.grad_clip,
                        lr_schedule=args.lr_schedule,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.total_steps)
    state = LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                          ema_params=init_ema(unet) if args.ema > 0 else None)
    state, ckpt = resume(args.ckpt_dir, state, gen, tx)
    step_fn = make_ldm_train_step(
        unet, schedule, tx, prediction=args.prediction,
        ema_decay=args.ema if args.ema > 0 else None,
        min_snr_gamma=args.min_snr_gamma if args.min_snr_gamma > 0 else None,
        dtype=dtype, reduce_grads=dp)

    def step(state, images):
        return step_fn(state, torch.from_numpy(images).to(device), generator=gen)

    validator = None
    if args.val_dir:
        from ldm_image_generator_tpu_torch.train.eval import Validator

        val_ds = ImageDataset(args.val_dir, size=args.size)
        validator = Validator(val_ds, unet, schedule, prediction=args.prediction,
                              batch=args.batch, max_batches=args.val_batches,
                              dtype=dtype)
        print(f"validation: {len(val_ds)} images, every {args.val_every} steps")

    return train_loop(state, step, BatchLoader(ds, args.batch, device_cast=True),
                      epochs=args.epoch,
                      batch_size=args.batch,
                      save_all=saver(args.modelpath, ckpt, gen, tx, dp),
                      save_every=args.save_every, validator=validator,
                      val_every=args.val_every)


if __name__ == "__main__":
    main()
