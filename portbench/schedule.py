"""Traffic generation from a mix's data file and the run's seed.

An open loop's arrivals are phases of constant rate; within a phase the
gaps between arrivals are the quantiles of the exponential distribution
of that rate (a Poisson process's gaps, evenly spread over their law),
and the seed only orders them. So every seed offers the same number of
requests with the same set of gaps and of kinds, and two seeds differ in
order alone: a run's spread comes from the system, not from how much
work its seed drew.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed (any integer)."""
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    """n gaps at the midpoint quantiles of Exp(rate), which average 1/rate
    as n grows."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def phases(traffic: dict, seconds: float) -> List[tuple]:
    """[(length s, rate /s)] covering the window: the mix's `phases`
    cycled, or one phase at `rate_per_s`."""
    spec = traffic.get("phases") or [{"seconds": seconds, "rate_per_s": traffic["rate_per_s"]}]
    out, t, i = [], 0.0, 0
    while t < seconds - 1e-9:
        p = spec[i % len(spec)]
        length = min(float(p["seconds"]), seconds - t)
        out.append((length, float(p["rate_per_s"])))
        t += length
        i += 1
    return out


def arrivals(traffic: dict, seed: int, seconds: float) -> List[dict]:
    """The open loop's requests, in time order: {due (s from the window's
    start), seed (a request's own, >= 1), kind (index into the mix)}."""
    g = rng(seed, 1)
    out, t0 = [], 0.0
    for length, rate in phases(traffic, seconds):
        n = int(round(length * rate))
        if n:
            gaps = exponential_gaps(n, rate)
            due = t0 + np.cumsum(g.permutation(gaps)) * (length / gaps.sum())
            out += [float(d) for d in due]
        t0 += length
    mix = traffic.get("mix") or [{"share": 1.0}]
    counts = [int(math.floor(m["share"] * len(out))) for m in mix]
    counts[0] += len(out) - sum(counts)
    kinds = g.permutation(np.repeat(np.arange(len(mix)), counts))
    seeds = g.integers(1, 2 ** 31 - 1, size=len(out))
    return [dict(due=d, seed=int(s), kind=int(k)) for d, s, k in zip(out, seeds, kinds)]
