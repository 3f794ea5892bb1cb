"""Train the latent diffusion UNet on frozen-encoder latents.

    python -m ldm_image_generator_tpu_torch.cli.train_ldm imgs/ \\
        -s 256 -b 8 -e 1 -fp16 true

The flags are those of the JAX package's cli/train_ldm.py that this port
covers. The images are encoded once by the VAE Encoder of the -ep
parameter file (seeded random weights where it does not exist) into the
content-addressed fp16 latent cache under ./dataset_cache/ (its key names
the encoder's parameters, so another encoder encodes afresh; a resumed
run reads the latents back), the
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

Parallel runs, as the JAX trainer's:
  - data parallel: start the same command in each of N processes with
    --coordinator HOST:PORT --process-id r --num-processes N (or the
    LDM_* env vars). Each process loads its stripe of every global batch
    (-b is the global batch), the gradients are all-reduced, and rank 0
    writes the files. --zero1 splits the Adam moments over the
    processes (parallel/mesh.py Zero1; the state file holds them whole,
    so a run resumes at any process count);
  - --pipeline-stages S [--pipeline-microbatches M]: the UNet's deep
    stacks run through the GPipe schedule (parallel/pipelined_unet.py)
    on the process's S cards ((rank * S + i) % device_count; S times the
    CPU with -d cpu), M microbatches per step (default S); combines with
    data parallelism across processes (not with --zero1).
"""
from __future__ import annotations

import argparse
from typing import Callable

from ldm_image_generator_tpu_torch.cli.common import (
    add_diffusion_args,
    add_launch_args,
    crossed,
    ema_path,
)
from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load, str2bool

# metrics are checked for NaN/Inf each time the step count crosses a
# multiple of this
FINITE_EVERY = 50


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train Latent Diffusion Model "
                                            "(PyTorch/CUDA port)")
    p.add_argument("dataset_path", nargs="+")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    add_launch_args(p)
    p.add_argument("-e", "--epoch", default=1, type=int)
    p.add_argument("-b", "--batch", default=1, type=int,
                   help="the global batch (split over the processes)")
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
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: split the Adam moments over the data-parallel "
                        "processes; numerics unchanged (ignored without them)")
    p.add_argument("--config", default="default",
                   choices=["default", "tiny", "tiny-deep"],
                   help="model size preset (tiny = test/debug scale; tiny-deep "
                        "= tiny with a pipelinable deep stack)")
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
    p.add_argument("--pipeline-stages", default=0, type=int,
                   help="GPipe pipeline parallelism: the UNet's deep homogeneous "
                        "stacks over this many stages (one card each); 0 = off")
    p.add_argument("--pipeline-microbatches", default=0, type=int,
                   help="microbatches per pipelined step (default: "
                        "= --pipeline-stages)")
    return p


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


def resume(ckpt_dir, state, gen, tx):
    """(state, checkpointer): with --ckpt-dir a TrainCheckpointer there
    (a directory it did not write exits) and the state restored from its
    latest step, the generator's state with it (a ZeRO-1 rank keeps its
    slices of the saved moments, tx.local_tree); else (state, None)."""
    if not ckpt_dir:
        return state, None
    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer

    try:
        ckpt = TrainCheckpointer(ckpt_dir)
    except ValueError as e:
        raise SystemExit(e.args[0]) from e
    restored = ckpt.restore(state, [gen], transform=lambda tree: dict(
        tree, opt_state=tx.local_tree(tree["opt_state"])))
    if restored is not None:
        state = restored
        print(f"Resumed from step {state.step}")
    return state, ckpt


def saver(modelpath: str, ckpt, gen, tx=None, dp=None) -> Callable:
    """save_all(state) of the diffusion trainers: the UNet to modelpath
    and the EMA (where kept) to modelpath + ".ema" as flax parameter
    files, and the full state (tx.full_state: ZeRO-1 moments whole; the
    optimizer tx is needed with a checkpointer) to the checkpointer
    (where there is one). Under a data-parallel group
    `dp` every rank calls it, rank 0 writes, and the ranks leave it
    together."""
    import dataclasses

    from ldm_image_generator_tpu_torch.convert import save_flax_file

    def save_all(state):
        if ckpt is not None:
            state = dataclasses.replace(state, opt_state=tx.full_state(state.opt_state))
        if dp is None or dp.rank == 0:
            save_flax_file(state.params, modelpath)
            saved = [modelpath]
            if state.ema_params is not None:
                save_flax_file(state.ema_params, ema_path(modelpath))
                saved.append(ema_path(modelpath))
            if ckpt is not None:
                saved.append(ckpt.save(state.step, state, [gen]))
            print("saved " + ", ".join(saved), flush=True)
        if dp is not None:
            dp.barrier()
    return save_all


def data_parallel(device):
    """A DataParallel over the process group, or None for one process."""
    import torch.distributed as dist

    from ldm_image_generator_tpu_torch.parallel.mesh import DataParallel

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    dp = DataParallel(device)
    print(f"data-parallel over {dp.world} processes", flush=True)
    return dp


def pipeline_check(args, world: int) -> int:
    """The microbatch count of --pipeline-stages S, after the JAX
    trainer's checks (S divides the device count, the batch splits into
    the microbatches)."""
    import torch

    s = args.pipeline_stages
    if args.device == "cuda" and torch.cuda.is_available():
        n = torch.cuda.device_count()
        if n % s:
            raise SystemExit(f"--pipeline-stages {s} must divide device count {n}")
    mb = args.pipeline_microbatches or s
    if (args.batch // world) % mb:
        raise SystemExit(f"batch {args.batch} must split into {mb} microbatches"
                         + (f" on each of {world} processes" if world > 1 else ""))
    return mb


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.fused_steps > 1 and args.pipeline_stages > 1:
        raise SystemExit("--fused-steps and --pipeline-stages cannot be combined")
    import dataclasses

    import torch

    from ldm_image_generator_tpu_torch.cli.common import launch_values, setup_device
    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DDPMConfig,
        UNetConfig,
        VAEConfig,
    )
    from ldm_image_generator_tpu_torch.data.dataset import (
        LatentImageDataset,
        module_fingerprint,
    )
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

    stages = max(args.pipeline_stages, 1)
    launch = launch_values(args)
    mb = pipeline_check(args, launch[2] if launch else 1) if stages > 1 else 0
    devices = setup_device(args, cards_per_rank=stages)
    device = devices[0]
    dp = data_parallel(device)
    ucfg, vcfg = UNetConfig(), VAEConfig()
    if args.config == "tiny":
        ucfg, vcfg = ucfg.tiny(), vcfg.tiny()
    elif args.config == "tiny-deep":
        ucfg, vcfg = ucfg.tiny_deep(), vcfg.tiny()
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

    fingerprint = module_fingerprint(encoder)
    ds = LatentImageDataset(args.dataset_path, size=args.size, max_len=args.maxdata,
                            encode_fn=encode, encoder_fingerprint=fingerprint)
    print(f"dataset: {len(ds)} latents "
          f"({args.size // vcfg.downscale}px, {vcfg.latent_channels}ch)")
    print(ds.cache_line())
    val_ds = None
    if args.val_dir:
        val_ds = LatentImageDataset(args.val_dir, size=args.size, encode_fn=encode,
                                    encoder_fingerprint=fingerprint)
    del encoder

    unet = UNet(ucfg, device=device, generator=gen)
    maybe_load(unet, args.modelpath, lambda sd: ti.convert_ddpm(sd, ucfg))
    apply_fn = None
    if stages > 1:
        from ldm_image_generator_tpu_torch.parallel.pipelined_unet import PipelinedUNet

        apply_fn = PipelinedUNet(unet, devices, mb)
        print(f"pipeline-parallel: {stages} stages x {dp.world if dp else 1} data "
              f"shards, {mb} microbatches (pipelined blocks per stage: "
              f"{apply_fn.pipelined()})")
    zero1 = None
    if args.zero1 and dp is not None and apply_fn is None:
        from ldm_image_generator_tpu_torch.parallel.mesh import Zero1

        zero1 = Zero1(list(unet.parameters()), dp)
        print("ZeRO-1: optimizer state split over the data-parallel processes")
    elif args.zero1:
        print("--zero1 ignored: no data-parallel mesh engaged "
              "(single device, pipeline mode, or batch % devices != 0)")
    schedule = make_schedule(DDPMConfig(prediction=args.prediction,
                                        zero_terminal_snr=args.zero_snr))
    tx = make_optimizer("adamw", args.learningrate,
                        accumulate=args.batch_multiply,
                        grad_clip=args.grad_clip, lr_schedule=args.lr_schedule,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.total_steps, zero1=zero1)
    state = LDMTrainState(params=unet, opt_state=tx.init(list(unet.parameters())),
                          ema_params=init_ema(unet) if args.ema > 0 else None)
    state, ckpt = resume(args.ckpt_dir, state, gen, tx)
    step_fn = make_ldm_train_step(
        unet, schedule, tx, prediction=args.prediction,
        ema_decay=args.ema if args.ema > 0 else None,
        min_snr_gamma=args.min_snr_gamma if args.min_snr_gamma > 0 else None,
        dtype=dtype, num_classes=num_classes, cond_drop=args.cond_drop,
        reduce_grads=dp, apply_fn=apply_fn)

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

    loader = BatchLoader(ds, args.batch, with_labels=num_classes > 0, device_cast=True)
    return train_loop(state, step, loader, epochs=args.epoch, batch_size=args.batch,
                      save_all=saver(args.modelpath, ckpt, gen, tx, dp),
                      save_every=args.save_every,
                      fused_steps=args.fused_steps, validator=validator,
                      val_every=args.val_every)


if __name__ == "__main__":
    main()
