"""The yardstick's arithmetic: the H100's published peaks, the least
bytes and operations of a kernel call at its shape (bfloat16 activations
and weights; a frozen copy of the program's kernels/workloads.py `work`
for that type), and the model FLOPs of a forward counted over the plain
reference by torch.utils.flop_counter.FlopCounterMode."""
from __future__ import annotations

import functools
import json

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM bytes/s
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2  # bytes per element


def block_calls(ucfg: dict, batch: int, latent: int):
    """[(channels, map side)] of every block's FFN call in forward order
    (encoder stages, then decoder stages from the deepest), at `batch`."""
    out = []
    n = len(ucfg["channels"])
    order = list(range(n)) + list(reversed(range(n)))
    for i in order:
        hw = (latent // ucfg["stem_size"]) >> i
        out += [(ucfg["channels"][i], hw)] * ucfg["stages"][i]
    return out


def ffn_block(rows: int, c: int, m: int, film_rows: int):
    """(bytes, flops) of one ffn_block call on `rows` tokens of width c:
    norm + FiLM + the general and two routed ReGLU experts of hidden width
    m. Reads x, the FiLM pair and the three towers' weights and biases
    once; writes the output and h."""
    weights = BF16 * 3 * (3 * c * m + 2 * m + c)
    nbytes = BF16 * (rows * c + 2 * film_rows * c + 2 * rows * c) + weights + 8
    return nbytes, 18 * rows * c * m


def ffn_block_bwd(rows: int, c: int, m: int):
    """(bytes, flops) of one ffn_block_bwd call: 8 products of rows x c x m
    per ReGLU, three ReGLUs; h, the cotangent in, dh out; the towers'
    weights read, their fp32 gradients written."""
    tower = 3 * (3 * c * m + 2 * m)
    return BF16 * (3 * rows * c + tower) + 4 * tower + 8, 48 * rows * c * m


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds on an H100: the larger of the bytes' and the
    operations' times at the published peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def call_bound_s(kernel: str, ucfg: dict, c: int, hw: int, batch: int, film_batch: int) -> float:
    rows = batch * hw * hw
    m = c * ucfg["ffn_mul"]
    if kernel == "ffn_block":
        return bound_s(*ffn_block(rows, c, m, film_batch * hw * hw))
    return bound_s(*ffn_block_bwd(rows, c, m))


@functools.lru_cache(maxsize=None)
def _forward_flops(ucfg_json: str, batch: int, latent: int, conditioned: bool,
                   t_per_sample: bool) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import unet as ref

    ucfg = json.loads(ucfg_json)
    meta = torch.device("meta")
    P = {n: torch.empty(s, device=meta) for n, (s, _) in ref.unet_shapes(ucfg).items()}
    x = torch.empty((batch, latent, latent, ucfg["input_channels"]), device=meta)
    t = torch.zeros((batch if t_per_sample else 1,), dtype=torch.int64, device=meta)
    cond = None
    if conditioned:
        cond = torch.empty((batch, ucfg["cond_tokens"], ucfg["cond_channels"]), device=meta)
    plan = [0] * len(ref.blocks(ucfg))
    with FlopCounterMode(display=False) as fc:
        ref.unet(P, ucfg, x, t, plan, None, cond)
    return int(fc.get_total_flops())


def unet_forward_flops(ucfg: dict, batch: int, latent: int, conditioned: bool,
                       t_per_sample: bool = False) -> int:
    """Matrix-product and convolution FLOPs of one UNet forward of the
    reference at this shape (the two routed experts of each block only);
    one timestep for the batch (sampling: the FiLM towers run once per
    call) or one per sample (training). Counted at batch 1 and 2 and
    extended to `batch`: every term is affine in it."""
    key = json.dumps(ucfg, sort_keys=True)
    one = _forward_flops(key, 1, latent, conditioned, t_per_sample)
    two = _forward_flops(key, 2, latent, conditioned, t_per_sample)
    return one + (batch - 1) * (two - one)


@functools.lru_cache(maxsize=None)
def _decoder_flops(vae_json: str, batch: int, latent: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import unet as ref

    vae = json.loads(vae_json)
    meta = torch.device("meta")
    P = {n: torch.empty(s, device=meta) for n, (s, _) in ref.decoder_shapes(vae).items()}
    z = torch.empty((batch, latent, latent, vae["latent_channels"]), device=meta)
    with FlopCounterMode(display=False) as fc:
        ref.decoder(P, vae, z)
    return int(fc.get_total_flops())


def decoder_flops(vae: dict, batch: int, latent: int) -> int:
    """FLOPs of the decoder at the batch (linear in it: counted at 1)."""
    return batch * _decoder_flops(json.dumps(vae, sort_keys=True), 1, latent)


def latent_side(cfg: dict) -> int:
    return cfg["image_size"] // 2 ** (len(cfg["vae"]["encoder_channels"]) - 1)


def sample_call_flops(cfg: dict, batch: int, guided: bool) -> int:
    """Model FLOPs of one sampling call of `batch` images: num_steps UNet
    forwards at the batch (two with classifier-free guidance) and the
    decoder."""
    latent = latent_side(cfg)
    cond = cfg["unet"]["num_classes"] > 0
    per_step = unet_forward_flops(cfg["unet"], batch, latent, cond) * (2 if guided else 1)
    return cfg["num_steps"] * per_step + decoder_flops(cfg["vae"], batch, latent)


def train_step_flops(cfg: dict, batch: int) -> int:
    """Model FLOPs of one train step: a forward at the batch (one timestep
    per sample) and a backward counted as twice the forward."""
    return 3 * unet_forward_flops(cfg["unet"], batch, latent_side(cfg),
                                  cfg["unet"]["num_classes"] > 0, t_per_sample=True)
