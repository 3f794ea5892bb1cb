"""Data parallelism and ZeRO-1 over a torch.distributed process group:
the torch counterparts of the data axis and zero1_shardings in
ldm_image_generator_tpu/parallel/mesh.py.

The JAX package shards the global batch over a 'data' mesh axis and
lets GSPMD insert the gradient psum; ZeRO-1 annotates the Adam moments
so that GSPMD lowers the update to reduce-scatter -> sharded update ->
all-gather. Here each process of the group is one replica holding its
rows of the global batch, and the collectives are explicit:

  - DataParallel all-reduces the gradients (mean) in a few flat buckets
    after the backward, so every rank holds the global batch's gradient
    and applies the same update. No DistributedDataParallel: the routed
    MoE leaves parameters unused in some steps, and the train step
    already gives every parameter an explicit (zero) gradient;
  - Zero1 splits each large optimizer-state leaf on its largest
    dimension divisible by the world size (zero1_shardings' rule): each
    rank keeps only its slice of the moments, updates only its slice of
    each split parameter from the all-reduced gradient, and the updated
    slices are all-gathered into every rank's parameters (gloo has no
    reduce-scatter, so the reduction is the same all-reduce).

The buckets are built on the rank's own device, so the collectives run
on one device per rank whatever devices the parameters lie on.
Tensor, expert and spatial layouts and multi-slice meshes are not ported
(ROADMAP A13b).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# ZeRO-1 leaves smaller than this stay replicated (zero1_shardings)
ZERO1_MIN_SIZE = 2 ** 14
# elements per flat bucket of a collective (64 MiB of fp32)
BUCKET_ELEMS = 2 ** 24


def _buckets(sizes: Sequence[int]) -> List[List[int]]:
    """Indices in order, cut into runs of at most BUCKET_ELEMS elements
    (one larger tensor makes a bucket of its own)."""
    out, cur, n = [], [], 0
    for i, size in enumerate(sizes):
        if cur and n + size > BUCKET_ELEMS:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += size
    if cur:
        out.append(cur)
    return out


def all_reduce_mean(tensors: Sequence[torch.Tensor], device: torch.device,
                    group=None) -> None:
    """Each tensor (fp32) replaced in place by its mean over the group:
    flat buckets on `device`, one all-reduce (sum) each, divided by the
    world size. Every rank receives the same bits."""
    world = dist.get_world_size(group)
    for idx in _buckets([t.numel() for t in tensors]):
        flat = torch.cat([tensors[i].detach().reshape(-1).to(device, torch.float32)
                          for i in idx])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


class DataParallel:
    """This process's place in a data-parallel group: its rank, the world
    size and the device its collectives run on. Calling it on a list of
    gradients all-reduces them (the reduce_grads of the train steps);
    `rows` gives the rank's stripe of the global batch."""

    def __init__(self, device, group=None):
        self.group = group
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)

    def __call__(self, grads: Sequence[torch.Tensor]) -> None:
        all_reduce_mean(grads, self.device, self.group)

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """The group's mean of `values` (a new tensor on its device)."""
        out = values.detach().to(self.device, torch.float32).clone()
        dist.all_reduce(out, group=self.group)
        return out.div_(self.world).to(values.device)

    def rows(self, global_batch: int) -> slice:
        """This rank's rows [lo, lo + B / W) of a global batch of B."""
        if global_batch % self.world:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{self.world} ranks")
        per = global_batch // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def zero1_dim(shape: Sequence[int], world: int,
              min_size: int = ZERO1_MIN_SIZE) -> Optional[int]:
    """The dimension a ZeRO-1 state leaf of `shape` splits on over
    `world` ranks: the largest divisible by world (the first of equal
    sizes), or None (replicated) for a leaf below min_size elements, a
    world of 1 or no divisible dimension."""
    n = 1
    for d in shape:
        n *= int(d)
    if n < min_size or world <= 1:
        return None
    for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
        if shape[i] % world == 0:
            return i
    return None


class Zero1:
    """The ZeRO-1 split of a list of parameters over a DataParallel
    group: plan[i] is the dimension parameter i's optimizer state splits
    on (zero1_dim), or None where it stays whole."""

    def __init__(self, params: Sequence[torch.Tensor], dp: DataParallel,
                 min_size: int = ZERO1_MIN_SIZE):
        self.dp = dp
        self.plan = [zero1_dim(tuple(p.shape), dp.world, min_size) for p in params]

    def local(self, t: torch.Tensor, i: int, rank: Optional[int] = None) -> torch.Tensor:
        """The slice (a view) of tensor `t`, shaped as parameter i, that
        `rank` (default: this one) owns; t itself where i stays whole."""
        d = self.plan[i]
        if d is None:
            return t
        r = self.dp.rank if rank is None else rank
        k = t.shape[d] // self.dp.world
        return t.narrow(d, r * k, k)

    def gather(self, tensors: Sequence[torch.Tensor]) -> None:
        """Every split tensor (parameter i's shape) made whole in place
        from each rank's slice of it: one all-gather per flat bucket."""
        split = [i for i, d in enumerate(self.plan) if d is not None]
        world, dev = self.dp.world, self.dp.device
        for idx in _buckets([tensors[split[j]].numel() // world
                             for j in range(len(split))]):
            idx = [split[j] for j in idx]
            mine = torch.cat([self.local(tensors[i], i).reshape(-1).to(dev)
                              for i in idx])
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine, group=self.dp.group)
            for r, part in enumerate(parts):
                off = 0
                for i in idx:
                    dst = self.local(tensors[i], i, rank=r)
                    dst.copy_(part[off:off + dst.numel()].view(dst.shape))
                    off += dst.numel()

    def gathered(self, locals_: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors (new, parameter i's shape) from each rank's
        slices `locals_` (whole ones are returned as they are)."""
        out = []
        for i, t in enumerate(locals_):
            if self.plan[i] is None:
                out.append(t)
                continue
            shape = list(t.shape)
            shape[self.plan[i]] *= self.dp.world
            whole = torch.empty(shape, dtype=t.dtype, device=t.device)
            self.local(whole, i).copy_(t)
            out.append(whole)
        self.gather(out)
        return out
