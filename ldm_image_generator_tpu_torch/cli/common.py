"""Training flags and helpers the trainers share, as the JAX package's
cli/common.py has them: the validation flags, the EMA file's path and
the cadence test of the train loop."""
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


def ema_path(modelpath: str) -> str:
    return modelpath + ".ema"


def crossed(prev: int, cur: int, every: int) -> bool:
    """True when a multiple of `every` lies in (prev, cur]: the cadence
    test of a loop whose step may advance by more than 1."""
    return prev // every != cur // every
