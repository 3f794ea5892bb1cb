"""Train the VQ-regularized VAE against its discriminator.

    python -m ldm_image_generator_tpu_torch.cli.train_vae imgs/ \\
        -s 512 -b 8 -e 1 -fp16 true

The flags are those of the JAX package's cli/train_vae.py. Every step
takes one random crop of the batch (192px, or the whole image below
that size), computes loss = recon * 10 + VQ reg + 0.1 * hinge adversarial
and takes an Adafactor step on the encoder, decoder and codebook, then a
hinge step on the discriminator, also Adafactor. Each model starts from
its parameter file (-ep, -dp, -qp, -discp) where it exists, else from
seeded random weights. The losses are printed every step, and every
--save-every batches the first reconstruction and the crop it was made
from are written to the result dir as JPEGs; at the end (also after an
interrupt) the four parameter files are written, each {"params": ...}
as the JAX package's. Runs on `cuda` unless `-d cpu` is given; a CUDA
request without a card raises.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ldm_image_generator_tpu_torch.cli.sample_ldm import maybe_load, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train VAE (PyTorch/CUDA port)")
    p.add_argument("dataset_path")
    p.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
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
    p.add_argument("--config", default="default", choices=["default", "tiny"],
                   help="model size preset (tiny = test/debug scale)")
    # flag of the JAX trainer whose path is not ported: refused below
    p.add_argument("--ckpt-dir", default=None)
    return p


def refusal(args):
    """The message refusing an option this port does not run yet, naming
    the ROADMAP item that brings it, or None."""
    if args.ckpt_dir is not None:
        return "--ckpt-dir is not ported yet: ROADMAP A7 (resume)"
    return None


def float_to_image(arr) -> np.ndarray:
    """[-1, 1] float HWC -> uint8 (clamp * 127.5 + 127.5, truncated)."""
    arr = np.clip(np.asarray(arr, dtype=np.float32), -1.0, 1.0)
    return (arr * 127.5 + 127.5).astype(np.uint8)


def save_jpeg(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(img, mode="RGB").save(path)


def main(argv=None):
    args = build_parser().parse_args(argv)
    why = refusal(args)
    if why:
        raise SystemExit(why)
    import torch
    from torch import nn

    from ldm_image_generator_tpu_torch.config import (
        DEFAULT_PRECISION,
        FULL_PRECISION,
        DiscriminatorConfig,
        VAEConfig,
        resolve_device,
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

    device = resolve_device(args.device)
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
    files = ((vae["encoder"], args.encpath), (vae["decoder"], args.decpath),
             (vae["quantizer"], args.quantizerpath), (disc, args.discpath))
    for module, path in files:
        maybe_load(module, path)
    ds = ImageDataset([args.dataset_path], size=args.size, max_len=args.maxdata)
    print(f"dataset: {len(ds)} images at {args.size}px")
    crop = 192 if args.size >= 192 else args.size
    tx_vae, tx_d = make_optimizer("adafactor"), make_optimizer("adafactor")
    state = VAETrainState(vae_params=vae, disc_params=disc,
                          opt_state_vae=tx_vae.init(list(vae.parameters())),
                          opt_state_disc=tx_d.init(list(disc.parameters())))
    step_fn = make_vae_train_step(vae["encoder"], vae["decoder"], vae["quantizer"],
                                  disc, tx_vae, tx_d, weight_recon=args.recon,
                                  crop_size=crop, dtype=dtype)
    loader = BatchLoader(ds, args.batch)
    os.makedirs(args.result, exist_ok=True)
    try:
        for epoch in range(args.epoch):
            print(f"Epoch #{epoch}")
            for batch_idx, images in enumerate(loader):
                state, metrics, (recon, cropped) = step_fn(
                    state, torch.from_numpy(images).to(device), generator=gen)
                print(f"step {state.step} " + " ".join(
                    f"{k} {v.item():.6f}" for k, v in metrics.items()))
                if batch_idx % args.save_every == 0:
                    for name, img in (("reconstructed", recon[0]),
                                      ("input", cropped[0])):
                        save_jpeg(float_to_image(img.float().cpu().numpy()),
                                  os.path.join(args.result,
                                               f"{batch_idx}_{name}.jpg"))
    finally:
        for module, path in files:
            save_flax_file(module, path)
        print("saved " + ", ".join(path for _, path in files))
    return state


if __name__ == "__main__":
    main()
