"""Train the VQ-regularized VAE against its discriminator.

    python -m ldm_image_generator_tpu_torch.cli.train_vae imgs/ \\
        -s 512 -b 8 -e 1 -fp16 true

The flags are those of the JAX package's cli/train_vae.py. Every step
takes one random crop of the batch (192px, or the whole image below
that size), computes loss = recon * 10 + VQ reg + 0.1 * hinge adversarial
and takes an Adafactor step on the encoder, decoder and codebook, then a
hinge step on the discriminator, also Adafactor. Each model starts from
its parameter file (-ep, -dp, -qp, -discp; flax msgpack, or the
reference's torch state_dict, converted) where it exists, else from
seeded random weights; --ckpt-dir resumes from the latest full training
state there (both optimizers' states, the step and the generator; the
port's own format, utils/checkpoint.py TrainCheckpointer). The losses go
to stdout as JSON lines every 10 steps and are checked for NaN/Inf every
50. Every --save-every batches the four parameter files are written,
each {"params": ...} as the JAX package's (and a checkpoint to
--ckpt-dir), with the first reconstruction and the crop it was made from
as JPEGs in the result dir; at the end the files are written again, also
after an interrupt or a SIGTERM, which ends the run after the step in
progress. Runs on `cuda` unless `-d cpu` is given; a CUDA request
without a card raises. --coordinator HOST:PORT --process-id r
--num-processes N (each process the same command) trains data-parallel:
-b is the global batch, each process loads its stripe of it, both nets'
gradients are all-reduced (the vq search runs on each process's rows),
and rank 0 writes the files. The images are decoded once into the
content-addressed fp16 cache under ./dataset_cache/ (data/dataset.py,
the JAX CLIs' place) and read back from it on every later run; batches
go to the card as fp16 and are cast there.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ldm_image_generator_tpu_torch.cli.common import add_launch_args
from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train VAE (PyTorch/CUDA port)")
    p.add_argument("dataset_path")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    add_launch_args(p)
    p.add_argument("-e", "--epoch", default=1, type=int)
    p.add_argument("-b", "--batch", default=1, type=int)
    p.add_argument("-r", "--result", default="./results")
    p.add_argument("-ep", "--encpath", default="./vae_encoder.pt")
    p.add_argument("-dp", "--decpath", default="./vae_decoder.pt")
    p.add_argument("-qp", "--quantizerpath", default="vae_quantizer.pt")
    p.add_argument("-discp", "--discpath", default="./discriminator.pt")
    p.add_argument("-fp16", default=False, type=str2bool,
                   help="bfloat16 compute (false: float32); params stay fp32")
    p.add_argument("-s", "--size", default=512, type=int)
    p.add_argument("-m", "--maxdata", default=-1, type=int)
    p.add_argument("--recon", default=10, type=float)
    p.add_argument("--save-every", default=100, type=int)
    p.add_argument("--ckpt-dir", default=None,
                   help="full training-state checkpoints (resume from the "
                        "latest step there)")
    p.add_argument("--config", default="default", choices=["default", "tiny"],
                   help="model size preset (tiny = test/debug scale)")
    return p


def float_to_image(arr) -> np.ndarray:
    """[-1, 1] float HWC -> uint8 (clamp * 127.5 + 127.5, truncated)."""
    arr = np.clip(np.asarray(arr, dtype=np.float32), -1.0, 1.0)
    return (arr * 127.5 + 127.5).astype(np.uint8)


def save_jpeg(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(img, mode="RGB").save(path)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch
    from torch import nn

    from ldm_image_generator_tpu_torch.cli.common import setup_device
    from ldm_image_generator_tpu_torch.cli.train_ldm import data_parallel
    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DiscriminatorConfig,
        VAEConfig,
    )
    from ldm_image_generator_tpu_torch.convert import save_flax_file
    from ldm_image_generator_tpu_torch.data.dataset import ImageDataset
    from ldm_image_generator_tpu_torch.data.loader import BatchLoader
    from ldm_image_generator_tpu_torch.models.vae import (
        Decoder,
        Discriminator,
        Encoder,
        VectorQuantizer,
    )
    from ldm_image_generator_tpu_torch.train.steps import (
        VAETrainState,
        make_optimizer,
        make_vae_train_step,
    )
    from ldm_image_generator_tpu_torch.utils import torch_import as ti
    from ldm_image_generator_tpu_torch.utils.checkpoint import TrainCheckpointer
    from ldm_image_generator_tpu_torch.utils.debug import (
        GracefulShutdown,
        assert_finite_metrics,
    )
    from ldm_image_generator_tpu_torch.utils.metrics import MetricLogger

    device = setup_device(args)[0]
    dp = data_parallel(device)
    writer = dp is None or dp.rank == 0
    cfg, dcfg = VAEConfig(), DiscriminatorConfig()
    if args.config == "tiny":
        cfg = cfg.tiny()
        dcfg = DiscriminatorConfig(channels=(8, 8), stages=(1, 1))
    dtype = (DEFAULT_PRECISION if args.fp16 else FULL_PRECISION).compute_dtype
    gen = torch.Generator(device=device).manual_seed(0)

    vae = nn.ModuleDict({
        "encoder": Encoder(cfg, device=device, generator=gen),
        "decoder": Decoder(cfg, device=device, generator=gen),
        "quantizer": VectorQuantizer(cfg.num_embeddings, cfg.embedding_dim,
                                     device=device, generator=gen)})
    disc = Discriminator(dcfg, device=device, generator=gen)
    files = ((vae["encoder"], args.encpath, lambda sd: ti.convert_encoder(sd, cfg)),
             (vae["decoder"], args.decpath, lambda sd: ti.convert_decoder(sd, cfg)),
             (vae["quantizer"], args.quantizerpath, ti.convert_quantizer),
             (disc, args.discpath, lambda sd: ti.convert_discriminator(sd, dcfg)))
    for module, path, converter in files:
        maybe_load(module, path, converter)
    ds = ImageDataset([args.dataset_path], size=args.size, max_len=args.maxdata)
    print(f"dataset: {len(ds)} images at {args.size}px")
    print(ds.cache_line())
    crop = 192 if args.size >= 192 else args.size
    tx_vae, tx_d = make_optimizer("adafactor"), make_optimizer("adafactor")
    state = VAETrainState(vae_params=vae, disc_params=disc,
                          opt_state_vae=tx_vae.init(list(vae.parameters())),
                          opt_state_disc=tx_d.init(list(disc.parameters())))
    ckpt = None
    if args.ckpt_dir:
        try:
            ckpt = TrainCheckpointer(args.ckpt_dir)
        except ValueError as e:
            raise SystemExit(e.args[0]) from e
        restored = ckpt.restore(state, [gen])
        if restored is not None:
            state = restored
            print(f"Resumed from step {state.step}")
    step_fn = make_vae_train_step(vae["encoder"], vae["decoder"], vae["quantizer"],
                                  disc, tx_vae, tx_d, weight_recon=args.recon,
                                  crop_size=crop, dtype=dtype, reduce_grads=dp)
    loader = BatchLoader(ds, args.batch, device_cast=True)
    logger = MetricLogger(log_every=10)
    os.makedirs(args.result, exist_ok=True)

    def save_all(state):
        """Rank 0 writes; under a group the ranks leave together."""
        if writer:
            for module, path, _ in files:
                save_flax_file(module, path)
            saved = [path for _, path, _ in files]
            if ckpt is not None:
                saved.append(ckpt.save(state.step, state, [gen]))
            print("saved " + ", ".join(saved), flush=True)
        if dp is not None:
            dp.barrier()

    shutdown = GracefulShutdown()
    try:
        for epoch in range(args.epoch):
            print(f"Epoch #{epoch}", flush=True)
            for batch_idx, images in enumerate(loader):
                state, metrics, (recon, cropped) = step_fn(
                    state, torch.from_numpy(images).to(device), generator=gen)
                logger.log(state.step, metrics, batch_size=args.batch)
                if state.step % 50 == 0:
                    assert_finite_metrics(metrics, state.step)
                if shutdown.requested:
                    print("SIGTERM received — saving and exiting", flush=True)
                    raise KeyboardInterrupt
                if batch_idx % args.save_every == 0:
                    save_all(state)
                    pairs = (("reconstructed", recon[0]), ("input", cropped[0]))
                    for name, img in pairs if writer else ():
                        save_jpeg(float_to_image(img.float().cpu().numpy()),
                                  os.path.join(args.result,
                                               f"{batch_idx}_{name}.jpg"))
    except KeyboardInterrupt:
        print("interrupted — saving", flush=True)
    finally:
        shutdown.restore()
        save_all(state)
    return state


if __name__ == "__main__":
    main()
