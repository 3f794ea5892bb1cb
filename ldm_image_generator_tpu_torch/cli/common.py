"""Flags and helpers the CLIs share, as the JAX package's cli/common.py
has them: the diffusion flags (and the trainers' validation,
optimizer-schedule and EMA flags), the EMA file's path and the cadence
test of the train loop."""
from __future__ import annotations

import argparse


def add_val_args(parser: argparse.ArgumentParser) -> None:
    """--val-dir, --val-every and --val-batches (JAX add_diffusion_args,
    train=True)."""
    parser.add_argument(
        "--val-dir", default=None, nargs="+", metavar="DIR",
        help="held-out image directory: evaluate the stratified validation "
             "loss (train/eval.py) every --val-every steps and log val_loss "
             "(+ val_loss_ema) to the JSONL metrics")
    parser.add_argument("--val-every", default=500, type=int, metavar="STEPS",
                        help="validation cadence in train steps (with --val-dir)")
    parser.add_argument("--val-batches", default=4, type=int, metavar="N",
                        help="number of fixed validation batches to average over")


def add_diffusion_args(parser: argparse.ArgumentParser, train: bool = False) -> None:
    """--prediction and --zero-snr; with train also --ema, the validation
    flags, --grad-clip and the LR schedule's (JAX add_diffusion_args)."""
    parser.add_argument("--prediction", default="eps", choices=["eps", "v"])
    parser.add_argument("--zero-snr", action="store_true",
                        help="zero terminal SNR schedule; needs --prediction v")
    if not train:
        return
    parser.add_argument("--ema", default=0.0, type=float, metavar="DECAY",
                        help="keep an EMA of the UNet params (e.g. 0.999)")
    add_val_args(parser)
    parser.add_argument("--grad-clip", default=0.0, type=float, metavar="NORM",
                        help="global-norm gradient clipping (0 = off)")
    parser.add_argument("--lr-schedule", default="constant",
                        choices=["constant", "cosine"])
    parser.add_argument("--warmup-steps", default=0, type=int, metavar="STEPS")
    parser.add_argument("--total-steps", default=0, type=int, metavar="STEPS")


def ema_path(modelpath: str) -> str:
    return modelpath + ".ema"


def crossed(prev: int, cur: int, every: int) -> bool:
    """True when a multiple of `every` lies in (prev, cur]: the cadence
    test of a loop whose step may advance by more than 1."""
    return prev // every != cur // every
