"""The numbers `correct` compares, each against its own limit
(limits/<cell>.json). Gaps of norms are taken leaf by leaf, the worst
leaf counting: |program's norm - reference's| over the larger of the
reference's norm of that leaf and of the median leaf."""
from __future__ import annotations

import statistics
from typing import Dict, Optional

# a leaf whose reference gradient is under this share of the median
# leaf's is moved by rounding alone (a key bias under softmax): left out
# of the parameters' and the EMA's change
STILL_LEAF = 1e-3


def image_numbers(gaps: list) -> Dict[str, float]:
    """img_<stat>: the worst image's value of each statistic of
    reference.sample.gaps over the compared images."""
    return {f"img_{k}": max(float(g[k].max()) for g in gaps) for k in gaps[0]}


def limited(numbers: Dict[str, float], limits: dict) -> list:
    """[(name, value, limit)] of the numbers that have a limit."""
    return [(k, v, limits[k]) for k, v in numbers.items() if k in limits]


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               only: Optional[set] = None) -> float:
    names = [n for n in want if only is None or n in only]
    # the median over the leaves the reference moves at all (an unused
    # leaf, such as an unconditioned model's cross-attention, reads 0)
    med = statistics.median(want[n] for n in names if want[n] > 0)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def moving_leaves(ref_grad_norms: Dict[str, float]) -> set:
    med = statistics.median(v for v in ref_grad_norms.values() if v > 0)
    return {n for n, v in ref_grad_norms.items() if v >= STILL_LEAF * med}


def train_numbers(prog: dict, want: dict) -> Dict[str, float]:
    """loss_gap (worst step), grad_gap (first step's gradients), change_gap
    and ema_gap (after the last checked step, moving leaves only)."""
    moving = moving_leaves(want["grad_norms"])
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(prog["losses"], want["losses"])),
        "grad_gap": worst_leaf(prog["grad_norms"], want["grad_norms"]),
        "change_gap": worst_leaf(prog["change_norms"], want["change_norms"], moving),
        "ema_gap": worst_leaf(prog["ema_change_norms"], want["ema_change_norms"], moving),
    }
