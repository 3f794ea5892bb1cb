"""Flags and helpers the CLIs share, as the JAX package's cli/common.py
has them: the multi-process launch, the diffusion flags (and the
trainers' validation, optimizer-schedule and EMA flags), the EMA file's
path and the cadence test of the train loop."""
from __future__ import annotations

import argparse
import os


def add_launch_args(parser: argparse.ArgumentParser) -> None:
    """The JAX CLIs' multi-process launch flags: the same command starts
    in every process with its rank (env fallbacks LDM_COORDINATOR,
    LDM_PROCESS_ID, LDM_NUM_PROCESSES for launchers that cannot template
    flags)."""
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="multi-process run: the address process 0 listens "
                             "on; forms a torch.distributed group")
    parser.add_argument("--process-id", default=None, type=int, metavar="N",
                        help="this process's rank in [0, --num-processes)")
    parser.add_argument("--num-processes", dest="num_processes_dist", default=None,
                        type=int, metavar="N", help="total number of processes")


def launch_values(args=None):
    """(coordinator, process id, process count) from the flags, else the
    LDM_* env vars; None for a 1-process run. Raises SystemExit with the
    JAX package's words unless all three or none are given."""
    get = lambda attr, env, cast: (
        getattr(args, attr, None)
        if args is not None and getattr(args, attr, None) is not None
        else (cast(os.environ[env]) if env in os.environ else None))
    coordinator = get("coordinator", "LDM_COORDINATOR", str)
    process_id = get("process_id", "LDM_PROCESS_ID", int)
    num_processes = get("num_processes_dist", "LDM_NUM_PROCESSES", int)
    if not coordinator and num_processes is None:
        return None
    if not coordinator or process_id is None or not num_processes:
        raise SystemExit(
            "multi-process launch needs all three of --coordinator, "
            "--process-id and --num-processes (or the LDM_* env vars)")
    if num_processes == 1:
        return None
    return coordinator, process_id, num_processes


def rank_devices(device, count: int = 1, rank: int = 0) -> list:
    """The `count` devices of process `rank`: on CUDA the cards
    (rank * count + i) % device_count, on the CPU the CPU `count` times."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return [device] * count
    n = torch.cuda.device_count()
    return [torch.device("cuda", (rank * count + i) % n) for i in range(count)]


def maybe_init_distributed(args=None, device="cpu", cards_per_rank: int = 1) -> bool:
    """Form the process group from the launch flags (launch_values);
    True when the run is multi-process. The backend follows from the
    layout: nccl when `device` is CUDA and every rank has cards of its
    own (num_processes * cards_per_rank <= the visible cards; rank r's
    first card is (r * cards_per_rank) % device_count), gloo otherwise
    (the CPU, or ranks that share a card)."""
    values = launch_values(args)
    if values is None:
        return False
    coordinator, process_id, num_processes = values
    import torch
    import torch.distributed as dist

    cuda = torch.device(device).type == "cuda"
    own_cards = cuda and num_processes * cards_per_rank <= torch.cuda.device_count()
    backend = "nccl" if own_cards else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes)
    print(f"distributed: process {process_id}/{num_processes} via {coordinator}, "
          f"backend {backend}", flush=True)
    return True


def setup_device(args, cards_per_rank: int = 1) -> list:
    """The devices this process runs on (`cards_per_rank` of them; one
    card per pipeline stage), the first made current, then the process
    group formed when the launch flags ask for one. A CUDA request
    without a card raises."""
    import torch

    from ldm_image_generator_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    launch = launch_values(args)
    devices = rank_devices(device, cards_per_rank, launch[1] if launch else 0)
    if device.type == "cuda":
        torch.cuda.set_device(devices[0])
    maybe_init_distributed(args, device, cards_per_rank)
    return devices


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
