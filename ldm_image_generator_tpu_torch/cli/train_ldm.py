"""Train the latent diffusion UNet on frozen-encoder latents.

    python -m ldm_image_generator_tpu_torch.cli.train_ldm imgs/ \\
        -s 256 -b 8 -e 1 -fp16 true

The flags are those of the JAX package's cli/train_ldm.py that this port
covers. The images are encoded once by the VAE Encoder of the -ep
parameter file (seeded random weights where it does not exist), the
UNet starts from the -mp file where it exists (else seeded random
weights; either file flax msgpack or the reference's torch state_dict,
converted), and each step is AdamW on the eps-prediction L1 loss
(optionally v-prediction, Min-SNR weighting, gradient clipping, an LR
schedule, accumulation over -bm steps and an EMA).

--num-classes N (-1: one class per dataset dir) trains a class-conditional
UNet, each positional dir one class, with the null class at --cond-drop.
--ckpt-dir resumes from the latest full training state there (the
port's own format, utils/checkpoint.py TrainCheckpointer). --fused-steps
N runs N steps per group with one metrics readback (the last step's
metrics plus each one's group max, `<k>_gmax`); an epoch's trailing
batches run unfused. --val-dir evaluates the stratified validation loss
(train/eval.py) every --val-every steps. Metrics go to stdout as JSON
lines every 10 steps; the metrics are checked for NaN/Inf every 50. The
UNet is written to -mp (and the EMA to -mp + ".ema", flax parameter
files as the JAX package's) with a checkpoint every --save-every batches
and at the end, also after an interrupt or a SIGTERM, which ends the run
after the step in progress. Runs on `cuda` unless `-d cpu` is given; a
CUDA request without a card raises.
"""
from __future__ import annotations

import argparse
from typing import Callable

from ldm_image_generator_tpu_torch.cli.common import add_diffusion_args, crossed, ema_path
from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load, str2bool

# metrics are checked for NaN/Inf each time the step count crosses a
# multiple of this
FINITE_EVERY = 50


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
    p.add_argument("--save-every", default=300, type=int)
    p.add_argument("--fused-steps", default=1, type=int,
                   help="train steps per group, with one metrics readback "
                        "per group; numerics identical to N single steps")
    p.add_argument("--ckpt-dir", default=None,
                   help="full training-state checkpoints (resume from the "
                        "latest step there)")
    p.add_argument("--config", default="default",
                   choices=["default", "tiny", "tiny-deep"],
                   help="model size preset (tiny = test/debug scale)")
    p.add_argument("--num-classes", default=0, type=int,
                   help="class-conditional training: each positional dataset "
                        "dir is one class (-1 = one class per dir); 0 = "
                        "unconditional")
    p.add_argument("--cond-drop", default=0.1, type=float,
                   help="probability of training on the null class (the CFG "
                        "unconditional branch)")
    add_diffusion_args(p, train=True)
    p.add_argument("--min-snr-gamma", default=0.0, type=float,
                   help="Min-SNR loss weighting gamma (0 = uniform)")
    # flags of the JAX trainer whose paths are not ported: refused below
    p.add_argument("--pipeline-stages", default=0, type=int)
    p.add_argument("--zero1", action="store_true")
    return p


def refusal(args):
    """The message refusing an option this port does not run yet, naming
    the ROADMAP item that brings it, or None."""
    todo = [
        (args.pipeline_stages != 0, "--pipeline-stages", "A13 (parallelism)"),
        (args.zero1, "--zero1", "A13 (parallelism)"),
        (args.config == "tiny-deep", "--config tiny-deep", "A13 (parallelism)"),
    ]
    for hit, flag, item in todo:
        if hit:
            return f"{flag} is not ported yet: ROADMAP {item}"
    return None


def run_group(step: Callable, state, group: list):
    """The steps of `group` in turn -> (state, metrics): one item's own
    metrics, or for several the last step's plus `<k>_gmax`, each
    metric's max over the group (torch.max propagates NaN, as jnp.max:
    a non-finite loss inside the group still reaches the checks)."""
    if len(group) == 1:
        return step(state, group[0])
    import torch

    ms = []
    for item in group:
        state, m = step(state, item)
        ms.append(m)
    out = dict(ms[-1])
    out.update({f"{k}_gmax": torch.stack([m[k] for m in ms]).max() for k in ms[-1]})
    return state, out


def train_loop(state, step: Callable, loader, *, epochs: int, batch_size: int,
               save_all: Callable, save_every: int = 300, fused_steps: int = 1,
               validator=None, val_every: int = 500, logger=None):
    """The JAX trainer's run loop: step(state, item) -> (state, metrics)
    over `epochs` passes of `loader`, `fused_steps` items per group, an
    epoch's trailing items unfused. After each group: a metrics record at
    the logger's cadence, validation when the step count crosses a
    multiple of val_every, the NaN/Inf check at multiples of FINITE_EVERY,
    and an exit on SIGTERM; save_all(state) when the group's batch index
    crosses a multiple of save_every, and at the end, after an interrupt,
    a SIGTERM or an error too. Returns the last state."""
    from ldm_image_generator_tpu_torch.utils.debug import (
        GracefulShutdown,
        assert_finite_metrics,
    )
    from ldm_image_generator_tpu_torch.utils.metrics import MetricLogger

    n_fused = max(1, fused_steps)
    logger = logger or MetricLogger(log_every=10)
    shutdown = GracefulShutdown()
    if n_fused > 1:
        print(f"fused-steps: {n_fused} train steps per group")

    def after(state, prev: int, metrics: dict) -> None:
        logger.log(state.step, metrics, batch_size=batch_size)
        if validator is not None and crossed(prev, state.step, val_every):
            logger.log_now(state.step, validator.run(state))
        if crossed(prev, state.step, FINITE_EVERY):
            assert_finite_metrics(metrics, state.step)
        if shutdown.requested:
            print("SIGTERM received — saving and exiting", flush=True)
            raise KeyboardInterrupt

    try:
        for epoch in range(epochs):
            print(f"Epoch #{epoch}", flush=True)
            buf, batch_idx = [], -1
            for batch_idx, item in enumerate(loader):
                buf.append(item)
                if len(buf) < n_fused:
                    continue
                group, buf = buf, []
                prev = state.step
                state, metrics = run_group(step, state, group)
                after(state, prev, metrics)
                if crossed(batch_idx - n_fused, batch_idx, save_every):
                    save_all(state)
                    print("Model is saved!")
            if buf:
                if batch_idx + 1 < n_fused:
                    print(f"warning: epoch yielded {batch_idx + 1} batches < "
                          f"--fused-steps {n_fused}; running them unfused")
                for item in buf:
                    prev = state.step
                    state, metrics = step(state, item)
                    after(state, prev, metrics)
    except KeyboardInterrupt:
        print("interrupted — saving", flush=True)
    finally:
        shutdown.restore()
        save_all(state)
    return state


def resume(ckpt_dir, state, gen):
    """(state, checkpointer): with --ckpt-dir a TrainCheckpointer there
    (a directory it did not write exits) and the state restored from its
    latest step, the generator's state with it; else (state, None)."""
    if not ckpt_dir:
        return state, None
    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer

    try:
        ckpt = TrainCheckpointer(ckpt_dir)
    except ValueError as e:
        raise SystemExit(e.args[0]) from e
    restored = ckpt.restore(state, [gen])
    if restored is not None:
        state = restored
        print(f"Resumed from step {state.step}")
    return state, ckpt


def saver(modelpath: str, ckpt, gen) -> Callable:
    """save_all(state) of the diffusion trainers: the UNet to modelpath
    and the EMA (where kept) to modelpath + ".ema" as flax parameter
    files, and the full state to the checkpointer (where there is one)."""
    from ldm_image_generator_tpu_torch.convert import save_flax_file

    def save_all(state):
        save_flax_file(state.params, modelpath)
        saved = [modelpath]
        if state.ema_params is not None:
            save_flax_file(state.ema_params, ema_path(modelpath))
            saved.append(ema_path(modelpath))
        if ckpt is not None:
            saved.append(ckpt.save(state.step, state, [gen]))
        print("saved " + ", ".join(saved), flush=True)
    return save_all


def main(argv=None):
    args = build_parser().parse_args(argv)
    why = refusal(args)
    if why:
        raise SystemExit(why)
    import dataclasses

    import torch

    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DDPMConfig,
        UNetConfig,
        VAEConfig,
        resolve_device,
    )
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
    from ldm_image_generator_tpu_torch.utils import torch_import as ti

    device = resolve_device(args.device)
    ucfg, vcfg = UNetConfig(), VAEConfig()
    if args.config == "tiny":
        ucfg, vcfg = ucfg.tiny(), vcfg.tiny()
    num_classes = args.num_classes
    if num_classes == -1:
        num_classes = len(args.dataset_path)
    if num_classes > 0:
        if len(args.dataset_path) > num_classes:
            raise SystemExit(f"--num-classes {num_classes} < {len(args.dataset_path)} "
                             "dataset dirs (labels are per source dir)")
        ucfg = dataclasses.replace(ucfg, num_classes=num_classes)
        print(f"class-conditional: {num_classes} classes (dir-per-class), "
              f"cond-drop {args.cond_drop}")
    dtype = (DEFAULT_PRECISION if args.fp16 else FULL_PRECISION).compute_dtype
    gen = torch.Generator(device=device).manual_seed(0)

    encoder = Encoder(vcfg, device=device, generator=gen)
    maybe_load(encoder, args.encpath, lambda sd: ti.convert_encoder(sd, vcfg))

    @torch.no_grad()
    def encode(imgs):
        return encoder(torch.from_numpy(imgs).to(device)).float().cpu().numpy()

    ds = LatentImageDataset(args.dataset_path, encode, size=args.size,
                            max_len=args.maxdata)
    print(f"dataset: {len(ds)} latents "
          f"({args.size // vcfg.downscale}px, {vcfg.latent_channels}ch)")
    val_ds = None
    if args.val_dir:
        val_ds = LatentImageDataset(args.val_dir, encode, size=args.size)
    del encoder

    unet = UNet(ucfg, device=device, generator=gen)
    maybe_load(unet, args.modelpath, lambda sd: ti.convert_ddpm(sd, ucfg))
    schedule = make_schedule(DDPMConfig(prediction=args.prediction,
                                        zero_terminal_snr=args.zero_snr))
    tx = make_optimizer("adamw", args.learningrate,
                        accumulate=args.batch_multiply,
                        grad_clip=args.grad_clip, lr_schedule=args.lr_schedule,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.total_steps)
    state = LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                          ema_params=init_ema(unet) if args.ema > 0 else None)
    state, ckpt = resume(args.ckpt_dir, state, gen)
    step_fn = make_ldm_train_step(
        unet, schedule, tx, prediction=args.prediction,
        ema_decay=args.ema if args.ema > 0 else None,
        min_snr_gamma=args.min_snr_gamma if args.min_snr_gamma > 0 else None,
        dtype=dtype, num_classes=num_classes, cond_drop=args.cond_drop)

    def step(state, item):
        latents, labels = item if num_classes > 0 else (item, None)
        if labels is not None:
            labels = torch.from_numpy(labels).to(device)
        return step_fn(state, torch.from_numpy(latents).to(device), generator=gen,
                       labels=labels)

    validator = None
    if val_ds is not None:
        from ldm_image_generator_tpu_torch.train.eval import Validator

        validator = Validator(val_ds, unet, schedule, prediction=args.prediction,
                              batch=args.batch, max_batches=args.val_batches,
                              dtype=dtype)
        print(f"validation: {len(val_ds)} latents, every {args.val_every} steps")

    loader = BatchLoader(ds, args.batch, with_labels=num_classes > 0)
    return train_loop(state, step, loader, epochs=args.epoch, batch_size=args.batch,
                      save_all=saver(args.modelpath, ckpt, gen),
                      save_every=args.save_every,
                      fused_steps=args.fused_steps, validator=validator,
                      val_every=args.val_every)


if __name__ == "__main__":
    main()
