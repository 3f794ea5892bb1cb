"""The yardstick's arithmetic for a DiT configuration (its `dit` block):
the least bytes and operations of a global attention call at its shape
(bfloat16), the model FLOPs of a forward counted over the plain reference
(portbench/reference/dit.py) by torch.utils.flop_counter.FlopCounterMode,
the same count from the published widths, and a sampling call's FLOPs.
The H100's peaks are portbench/work.py's."""
from __future__ import annotations

import functools
import json

import torch

from portbench import work
from portbench.work import BF16


def attention_call(rows: int, tokens: int, heads: int, head_dim: int):
    """(bytes, flops) of one attention call: softmax(q k^T) v over every
    token, two products of rows x heads x tokens^2 x head_dim; reads q, k,
    v and writes o once, in bf16."""
    return BF16 * 4 * rows * tokens * heads * head_dim, 4 * rows * heads * tokens ** 2 * head_dim


def attention_bound_s(rows: int, tokens: int, heads: int, head_dim: int) -> float:
    """The least seconds of an attention call on an H100 (the larger of
    its bytes' and its operations' times)."""
    return work.bound_s(*attention_call(rows, tokens, heads, head_dim))


def forward_flops_from_widths(dcfg: dict, batch: int, t_per_sample: bool = False) -> int:
    """Matrix-product FLOPs (2 x MACs) of one forward from the widths:
    per token the patch embedding, each block's qkv, proj and MLP and the
    final linear; per row the class-conditioned adaLN projections (each
    block's 6D and the final 2D) and attention's two products; the
    timestep MLP once (once per row with t_per_sample)."""
    d, p, c = dcfg["hidden_size"], dcfg["patch_size"], dcfg["in_channels"]
    m = int(d * dcfg["mlp_ratio"])
    oc = c * (2 if dcfg["learn_sigma"] else 1)
    tokens = (dcfg["input_size"] // p) ** 2
    per_token = c * p * p * d + dcfg["depth"] * (3 * d * d + d * d + 2 * d * m) + d * p * p * oc
    per_row = (tokens * per_token + dcfg["depth"] * (6 * d * d + 2 * tokens * tokens * d)
               + 2 * d * d)
    embed = 256 * d + d * d
    return 2 * (batch * per_row + (batch if t_per_sample else 1) * embed)


@functools.lru_cache(maxsize=None)
def _forward_flops(dcfg_json: str, batch: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import dit as ref

    dcfg = json.loads(dcfg_json)
    meta = torch.device("meta")
    P = {n: torch.empty(s, device=meta) for n, (s, _) in ref.shapes(dcfg).items()}
    side = dcfg["input_size"]
    x = torch.empty((batch, side, side, dcfg["in_channels"]), device=meta)
    t = torch.zeros((1,), dtype=torch.int64, device=meta)
    y = torch.zeros((batch,), dtype=torch.int64, device=meta)
    with FlopCounterMode(display=False) as fc:
        ref.forward(P, dcfg, x, t, y)
    return int(fc.get_total_flops())


def forward_flops(dcfg: dict, batch: int) -> int:
    """Matrix-product and convolution FLOPs of one forward of the reference
    at this batch, one timestep for the batch (sampling), counted by
    FlopCounterMode at batch 1 and 2 and extended: every term is affine
    in it."""
    key = json.dumps(dcfg, sort_keys=True)
    one, two = _forward_flops(key, 1), _forward_flops(key, 2)
    return one + (batch - 1) * (two - one)


def sample_call_flops(cfg: dict, batch: int, guided: bool) -> int:
    """Model FLOPs of one sampling call of `batch` images: num_steps DiT
    forwards at the batch (two with classifier-free guidance) and the
    decoder."""
    per_step = forward_flops(cfg["dit"], batch) * (2 if guided else 1)
    return (cfg["num_steps"] * per_step
            + work.decoder_flops(cfg["vae"], batch, work.latent_side(cfg)))
