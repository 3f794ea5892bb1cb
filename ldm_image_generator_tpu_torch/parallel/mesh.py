"""The device mesh and its layouts over a torch.distributed process
group: the torch counterparts of ldm_image_generator_tpu/parallel/mesh.py
(make_mesh, make_multislice_mesh, batch_sharding, spatial_sharding,
param_shardings, shard_params, zero1_shardings).

The JAX package names the axes of one jax.sharding.Mesh and lets GSPMD
insert the collectives. Here each process of the group is one device of
the mesh, at the coordinates JAX's row-major reshape gives it, and the
collectives are explicit, each over one axis's subgroup:

  - data parallelism (the 'data' axis, or 'replica' x 'data' on a
    multi-slice mesh): DataParallel all-reduces the gradients (mean) in
    a few flat buckets after the backward, so every rank of a model
    coordinate holds the global batch's gradient and applies the same
    update. On a multi-slice mesh the reduction is hierarchical, as the
    JAX package's axis order lays it out for XLA: one all-reduce (sum)
    over the slice's data group, then one over the replica group, then
    the division by replica x data (gloo has no reduce-scatter, and the
    NCCL path takes the same all-reduces). No DistributedDataParallel:
    the routed MoE leaves parameters unused in some steps, and the train
    step already gives every parameter an explicit (zero) gradient;
  - ZeRO-1 (Zero1, over a DataParallel's group): each large
    optimizer-state leaf splits on its largest dimension divisible by the
    data size (zero1_shardings' rule); each rank keeps only its slice of
    the moments, updates only its slice of each split parameter from the
    all-reduced gradient, and the updated slices are all-gathered;
  - tensor and expert parallelism (the 'model' axis; shard_params): each
    rank keeps only its slice of every parameter param_shardings' rule
    splits (kernel_spec: the output features of a large kernel, or with
    expert_parallel the expert axis of the stacked experts). The kernels
    have no partitioning rule, as the JAX package's Pallas calls have
    none (GSPMD all-gathers a sharded operand of a pallas_call): before a
    SwinBlock's forward (and before the root module's, for the
    parameters outside every block) its split parameters are
    all-gathered over the model group into whole tensors in one flat
    bucket, and the kernels run on them unchanged. Under expert_parallel
    only the routed experts' slices of the stacked expert weights are
    broadcast from the ranks that own them, and the block runs on expert
    ids remapped to 0..k-1. The model group's ranks see the same batch
    rows (the batch splits over the data axes only), so their gradients
    of a whole weight are equal: each rank keeps its own slice, with no
    communication, and the data-parallel mean follows. With data size 1
    a step is bitwise the one-process step;
  - spatial parallelism (the 'model' axis over the image height;
    spatial_parallel): each rank holds its rows of every feature map,
    parameters replicated. Per-pixel work stays local; the 3x3 grouped
    conv takes a one-row halo from each neighbour (halo_rows), window
    attention all-gathers the map's height (gather_rows) and keeps its
    own rows, and the gradients and the loss are summed over the model
    group before the data-parallel mean.

The buckets are built on the rank's own device, so the collectives run
on one device per rank whatever devices the parameters lie on.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

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


def all_reduce_sum(tensors: Sequence[torch.Tensor], device: torch.device,
                   *groups, divisor: int = 1) -> None:
    """Each tensor replaced in place by its fp32 sum over each of `groups`
    in turn (default: every process), divided by `divisor`: flat buckets
    on `device`, one all-reduce per group each. Every rank of the groups
    receives the same bits."""
    for idx in _buckets([t.numel() for t in tensors]):
        flat = torch.cat([tensors[i].detach().reshape(-1).to(device, torch.float32)
                          for i in idx])
        for group in groups or (None,):
            dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def all_reduce_mean(tensors: Sequence[torch.Tensor], device: torch.device,
                    group=None, outer=None) -> None:
    """Each tensor (fp32) replaced in place by its mean over the group;
    with `outer` (a multi-slice mesh's replica group) the group's sums are
    all-reduced once more over it before the division by both sizes."""
    groups = (group,) if outer is None else (group, outer)
    all_reduce_sum(tensors, device, *groups,
                   divisor=math.prod(dist.get_world_size(g) for g in groups))


class DataParallel:
    """This process's place in a data-parallel group: its rank, the world
    size and the device its collectives run on. Calling it on a list of
    gradients all-reduces them (the reduce_grads of the train steps);
    `rows` gives the rank's stripe of the global batch. group: the data
    axes' group (default: every process); inner and outer: a multi-slice
    mesh's data and replica groups, whose two all-reduces then make the
    mean in place of one over `group` (Mesh.data_parallel)."""

    # a spatial split of the feature maps (SpatialDataParallel), or None
    spatial = None

    def __init__(self, device, group=None, inner=None, outer=None):
        self.group = group
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._reduce = (group, None) if outer is None else (inner, outer)

    def __call__(self, grads: Sequence[torch.Tensor]) -> None:
        all_reduce_mean(grads, self.device, *self._reduce)

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """The group's mean of `values` (a new tensor on its device)."""
        out = values.detach().to(self.device, torch.float32).clone()
        all_reduce_mean([out], self.device, *self._reduce)
        return out.to(values.device)

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


# --- the mesh ---------------------------------------------------------------

class Mesh:
    """The first n processes of the group as a device mesh with named
    axes, the counterpart of a jax.sharding.Mesh over the first n devices
    (one device per process): shape {axis: size} in axis order, rank r at
    the coordinates of JAX's row-major reshape (the last axis fastest).
    Every axis, the data axes ('replica', 'data') of a multi-slice mesh
    together, and the whole mesh have their own subgroups (dist.new_group,
    made by every process of the group in the same order), so a
    collective runs over one axis; `group(axis)` is this rank's. A
    process past the first n is no member: it has no coordinates and no
    groups."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size()
        if self.size > world:
            raise ValueError(f"a mesh of {self.size} devices {self.shape} over a "
                             f"process group of {world}")
        self.rank = dist.get_rank()
        self.member = self.rank < self.size
        self.coords = self.coords_of(self.rank) if self.member else None
        self.data_axes = (("replica", "data") if "replica" in self.shape
                          else ("data",))
        self._groups: Dict[tuple, tuple] = {}
        for axes in [(a,) for a in self.axis_names] + [self.data_axes, self.axis_names]:
            if axes not in self._groups:
                self._groups[axes] = self._new_groups(axes)

    def coords_of(self, rank: int) -> Dict[str, int]:
        out, r = {}, rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _new_groups(self, axes: tuple) -> tuple:
        """(group, its global ranks) of this rank over `axes`: the ranks
        that differ from it in those axes only, in row-major order over
        them (so a rank's place in the group is its row-major index
        there)."""
        members: Dict[tuple, list] = {}
        for r in range(self.size):
            c = self.coords_of(r)
            members.setdefault(tuple(c[a] for a in self.axis_names if a not in axes),
                               []).append(r)
        mine = None
        for ranks in members.values():
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = (group, ranks)
        return mine

    def _mine(self, axis) -> tuple:
        if not self.member:
            raise ValueError(f"process {self.rank} is not in this mesh of {self.size}")
        return self._groups[axis if isinstance(axis, tuple) else (axis,)]

    def group(self, axis) -> "dist.ProcessGroup":
        return self._mine(axis)[0]

    def group_ranks(self, axis) -> List[int]:
        return self._mine(axis)[1]

    def barrier(self) -> None:
        """A barrier over the mesh's processes."""
        dist.barrier(group=self.group(self.axis_names))

    @property
    def data_group(self):
        return self.group(self.data_axes)

    @property
    def data_size(self) -> int:
        return math.prod(self.shape[a] for a in self.data_axes)

    @property
    def data_index(self) -> int:
        """This rank's row-major index over the data axes (its place in
        data_group)."""
        i = 0
        for a in self.data_axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def data_groups(self) -> dict:
        """DataParallel's groups over the data axes: on a multi-slice mesh
        its mean is the hierarchical pair of all-reduces (data, then
        replica)."""
        if "replica" in self.shape:
            return dict(group=self.data_group, inner=self.group("data"),
                        outer=self.group("replica"))
        return dict(group=self.data_group)

    def data_parallel(self, device) -> Optional[DataParallel]:
        """The train step's reduce_grads over the data axes, or None where
        they hold one device (each rank's batch is then the global one,
        and a mean over one rank would only copy the gradients)."""
        if self.data_size == 1:
            return None
        return DataParallel(device, **self.data_groups())


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """A ('data', 'model') mesh over the first n_devices processes of the
    group (default: all of them; every process is one device)."""
    n_devices = dist.get_world_size() if n_devices is None else n_devices
    assert n_devices % model_parallel == 0, (n_devices, model_parallel)
    return Mesh({"data": n_devices // model_parallel, "model": model_parallel})


def make_multislice_mesh(n_devices: Optional[int] = None, replicas: int = 1,
                         model_parallel: int = 1) -> Mesh:
    """A ('replica', 'data', 'model') mesh: the outer replica axis spans
    slices, data and model stay within one; the gradient mean over
    ('replica', 'data') is hierarchical (Mesh.data_parallel)."""
    n_devices = dist.get_world_size() if n_devices is None else n_devices
    per_replica = n_devices // replicas
    assert replicas * per_replica == n_devices, (n_devices, replicas)
    assert per_replica % model_parallel == 0, (per_replica, model_parallel)
    return Mesh({"replica": replicas, "data": per_replica // model_parallel,
                 "model": model_parallel})


def batch_rows(mesh: Mesh, global_batch: int) -> slice:
    """This rank's stripe of a global batch over the data axes
    (batch_sharding: ('replica', 'data') on a multi-slice mesh)."""
    n = mesh.data_size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} data shards")
    per = global_batch // n
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def spatial_rows(mesh: Mesh, global_batch: int, height: int) -> Tuple[slice, slice]:
    """(batch stripe, rows of the image height) of this rank
    (spatial_sharding: batch over the data axes, height over 'model')."""
    m = mesh.shape["model"]
    if height % m:
        raise ValueError(f"image height {height} does not split over {m} ranks")
    per = height // m
    i = mesh.coords["model"]
    return batch_rows(mesh, global_batch), slice(i * per, (i + 1) * per)


# --- tensor and expert parallelism -----------------------------------------

MIN_TP_FEATURES = 256
EXPERT_LEAVES = ("wa", "wb", "wc")


def kernel_spec(leaf: str, shape: Sequence[int], model_size: int,
                expert_parallel: bool) -> Optional[int]:
    """The dimension of a parameter (flax leaf name `leaf`, flax shape)
    that splits over 'model', or None where it stays whole: the JAX
    package's _kernel_spec. TP: a kernel's trailing (output-feature) axis
    when divisible by the model size and at least MIN_TP_FEATURES; EP: a
    3-D stacked expert weight (wa, wb, wc) on its expert axis when that
    divides; 1-D tensors and a model size of 1 stay whole."""
    if model_size <= 1 or len(shape) < 2:
        return None
    if (expert_parallel and len(shape) == 3 and shape[0] >= model_size
            and shape[0] % model_size == 0 and leaf in EXPERT_LEAVES):
        return 0
    out = shape[-1]
    if out % model_size or out < MIN_TP_FEATURES:
        return None
    return len(shape) - 1


def param_plan(module: nn.Module, mesh: Mesh,
               expert_parallel: bool = False) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension it splits on over 'model', or None}
    for every parameter of `module` (param_shardings; the names are the
    flax tree's, joined by dots)."""
    m = mesh.shape.get("model", 1)
    return {n: kernel_spec(n.rsplit(".", 1)[-1], tuple(p.shape), m, expert_parallel)
            for n, p in module.named_parameters()}


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, leaf = name.split(".")
    for k in path:
        module = getattr(module, k)
    return module, leaf


class _GatherSlices(torch.autograd.Function):
    """Whole tensors from each model rank's slices (one all-gather of a
    flat bucket); the backward keeps this rank's slice of each whole
    gradient (the model group's ranks hold equal ones)."""

    @staticmethod
    def forward(ctx, shards, dims, *local):
        ctx.dims, ctx.rank = dims, shards.rank
        ctx.sizes = [t.shape[d] for t, d in zip(local, dims)]
        flat = torch.cat([t.reshape(-1) for t in local])
        parts = [torch.empty_like(flat) for _ in range(shards.world)]
        dist.all_gather(parts, flat, group=shards.group)
        out, off = [], 0
        for t, d in zip(local, dims):
            n = t.numel()
            out.append(torch.cat([p[off:off + n].view(t.shape) for p in parts], d))
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(
            g.narrow(d, ctx.rank * k, k).contiguous()
            for g, d, k in zip(grads, ctx.dims, ctx.sizes))


class _SelectExperts(torch.autograd.Function):
    """The routed experts' rows [k, ...] of stacked expert weights split
    over the model group on their expert axis: each owner broadcasts its
    experts' rows (one flat bucket per owner). The backward puts each
    routed expert's gradient into the owner's slice (the model group's
    ranks hold equal gradients of the selected rows)."""

    @staticmethod
    def forward(ctx, shards, ids, *local):
        per = local[0].shape[0]
        ctx.ids, ctx.per, ctx.rank = ids, per, shards.rank
        outs = [torch.empty((len(ids),) + tuple(t.shape[1:]), dtype=t.dtype,
                            device=t.device) for t in local]
        for owner in sorted({e // per for e in ids}):
            mine = [(j, e % per) for j, e in enumerate(ids) if e // per == owner]
            if owner == shards.rank:
                flat = torch.cat([t[e].reshape(-1) for t in local for _, e in mine])
            else:
                flat = torch.empty(sum(t[0].numel() for t in local) * len(mine),
                                   dtype=local[0].dtype, device=local[0].device)
            dist.broadcast(flat, src=shards.ranks[owner], group=shards.group)
            off = 0
            for t, o in zip(local, outs):
                for j, _ in mine:
                    n = t[0].numel()
                    o[j].copy_(flat[off:off + n].view(t.shape[1:]))
                    off += n
        ctx.shapes = [t.shape for t in local]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, shape in zip(grads, ctx.shapes):
            gl = torch.zeros(shape, dtype=g.dtype, device=g.device)
            for j, e in enumerate(ctx.ids):
                if e // ctx.per == ctx.rank:
                    gl[e % ctx.per] += g[j]
            out.append(gl)
        return (None, None) + tuple(out)


class ParamShards:
    """A module's parameters split over a mesh's model axis (shard_params):
    the plan, the forward hooks that make the split parameters whole, and
    what the optimizers and checks read (split_dim, sq_sum, gathered)."""

    def __init__(self, module: nn.Module, mesh: Mesh, expert_parallel: bool):
        from ldm_image_generator_tpu_torch.models.layers import SwinBlock

        self.module, self.mesh = module, mesh
        self.group = mesh.group("model")
        self.ranks = mesh.group_ranks("model")
        self.rank, self.world = mesh.coords["model"], mesh.shape["model"]
        self.plan = param_plan(module, mesh, expert_parallel)
        self.expert = {n for n, d in self.plan.items()
                       if expert_parallel and d == 0 and n.rsplit(".", 1)[-1] in EXPERT_LEAVES}
        with torch.no_grad():
            for name, d in self.plan.items():
                if d is None:
                    continue
                owner, leaf = _owner(module, name)
                p = owner._parameters[leaf]
                k = p.shape[d] // self.world
                owner._parameters[leaf] = nn.Parameter(
                    p.narrow(d, self.rank * k, k).clone(), requires_grad=p.requires_grad)
        # {id(parameter): the dimension its slice is of}, split ones only
        self.split_dim = {id(p): self.plan[n] for n, p in module.named_parameters()
                          if self.plan[n] is not None}
        # unit: each SwinBlock gathers its own split parameters, the root
        # those outside every block
        blocks = [n for n, m in module.named_modules() if isinstance(m, SwinBlock)]
        units: Dict[str, List[str]] = {}
        for name, d in self.plan.items():
            if d is None:
                continue
            unit = next((b for b in blocks if name.startswith(b + ".")), "")
            units.setdefault(unit, []).append(name)
        for unit, names in units.items():
            m = module.get_submodule(unit) if unit else module
            tp = [n for n in names if n not in self.expert]
            ep = [n for n in names if n in self.expert]
            m.register_forward_pre_hook(self._pre_hook(tp, ep), with_kwargs=True)
            m.register_forward_hook(self._post_hook(tp + ep, ep))

    def _pre_hook(self, tp: List[str], ep: List[str]):
        def hook(block, args, kwargs):
            self.set_whole(tp)
            if ep:
                kwargs = self._select_experts(ep, kwargs)
            return args, kwargs
        return hook

    def _post_hook(self, names: List[str], ep: List[str]):
        def hook(block, args, out):
            self.clear(names)
            if ep:
                prefix = ep[0].rsplit(".", 1)[0]
                self.clear([f"{prefix}.{b}" for b in ("ba", "bb", "bc")])
            return out
        return hook

    def set_whole(self, names: List[str]) -> None:
        """Make the split parameters `names` whole (through the gather's
        autograd) where their modules read them, until clear()."""
        if not names:
            return
        local = [self.module.get_parameter(n) for n in names]
        whole = _GatherSlices.apply(self, tuple(self.plan[n] for n in names), *local)
        for n, w in zip(names, whole):
            owner, leaf = _owner(self.module, n)
            owner.__dict__[leaf] = w

    def clear(self, names: List[str]) -> None:
        for n in names:
            owner, leaf = _owner(self.module, n)
            owner.__dict__.pop(leaf, None)

    def _select_experts(self, ep: List[str], kwargs: dict) -> dict:
        """The routed experts' weights (and bias rows) where the block's
        MoE reads them, and the block's expert ids remapped to 0..k-1."""
        ffn_name = ep[0].rsplit(".", 1)[0]
        ffn = self.module.get_submodule(ffn_name)
        ids = kwargs.get("expert_ids")
        if ids is None:
            ids = ffn.fixed_ids
        ids_list = [int(e) for e in ids.tolist()]
        local = [self.module.get_parameter(n) for n in ep]
        for n, w in zip(ep, _SelectExperts.apply(self, ids_list, *local)):
            ffn.__dict__[n.rsplit(".", 1)[-1]] = w
        index = torch.as_tensor(ids_list, device=ffn.fixed_ids.device)
        for b in ("ba", "bb", "bc"):
            ffn.__dict__[b] = getattr(ffn, b).index_select(0, index)
        return dict(kwargs, expert_ids=torch.arange(len(ids_list), dtype=torch.int32,
                                                    device=ids.device))

    @torch.no_grad()
    def gathered(self, grads: bool = False) -> Dict[str, torch.Tensor]:
        """{name: whole parameter}, or with `grads` {name: whole gradient},
        of every parameter (new tensors for the split ones; every model
        rank must call this)."""
        out = {}
        for n, p in self.module.named_parameters():
            t = (p.grad if grads else p).detach()
            d = self.plan[n]
            if d is None:
                out[n] = t
                continue
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t.contiguous(), group=self.group)
            out[n] = torch.cat(parts, d)
        return out

    def sq_sum(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of squares of the whole gradients: the split ones'
        slices summed over the model group (the clip's global norm)."""
        dev = grads[0].device
        zero = torch.zeros((), device=dev)
        sq = [g.float().square().sum().to(dev) for g in grads]
        split = sum((s for p, s in zip(params, sq) if id(p) in self.split_dim), zero)
        whole = sum((s for p, s in zip(params, sq) if id(p) not in self.split_dim), zero)
        split = split.reshape(1).clone()
        dist.all_reduce(split, group=self.group)
        return whole + split[0]


def shard_params(module: nn.Module, mesh: Mesh,
                 expert_parallel: bool = False) -> ParamShards:
    """Split `module`'s parameters in place by param_plan: each rank keeps
    only its slice of every split parameter (a new nn.Parameter of the
    same name; its gradient and the optimizer's moments follow it), and
    forward hooks make them whole where the module computes (see the
    module docstring). Call before the optimizer's init and init_ema."""
    return ParamShards(module, mesh, expert_parallel)


# --- spatial parallelism ----------------------------------------------------

class _HaloRows(torch.autograd.Function):
    """x [B, h, W, C] -> [B, h + 2, W, C]: the neighbours' boundary rows
    above and below (zeros at the map's edges). The backward sends each
    halo row's gradient back to its owner."""

    @staticmethod
    def forward(ctx, sp, x):
        ctx.sp = sp
        ends = torch.cat([x[:, :1], x[:, -1:]], 1).float().contiguous()
        parts = sp.all_gather(ends)
        zero = torch.zeros_like(ends[:, :1])
        above = parts[sp.rank - 1][:, 1:] if sp.rank > 0 else zero
        below = parts[sp.rank + 1][:, :1] if sp.rank < sp.world - 1 else zero
        return torch.cat([above.to(x.dtype), x, below.to(x.dtype)], 1)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        parts = sp.all_gather(torch.cat([g[:, :1], g[:, -1:]], 1).float().contiguous())
        gx = g[:, 1:-1].to(torch.float32, copy=True)
        if sp.rank < sp.world - 1:  # the row below's owner held my last row
            gx[:, -1:] += parts[sp.rank + 1][:, :1]
        if sp.rank > 0:
            gx[:, :1] += parts[sp.rank - 1][:, 1:]
        return None, gx.to(g.dtype)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows [B, h, W, C] -> the whole map [B, world * h, W, C];
    the backward sums the whole map's gradient over the group and keeps
    this rank's rows."""

    @staticmethod
    def forward(ctx, sp, x):
        ctx.sp, ctx.h = sp, x.shape[1]
        return torch.cat(sp.all_gather(x.float().contiguous()), 1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        g32 = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(g32, group=sp.group)
        return None, g32[:, sp.rank * ctx.h:(sp.rank + 1) * ctx.h].to(g.dtype)


class SpatialSplit:
    """A rank's stripe of the image height over a mesh's model axis: what
    the UNet's blocks read under spatial parallelism (models/layers.py)."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.group("model")
        self.rank, self.world = mesh.coords["model"], mesh.shape["model"]

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.group)
        return parts

    def rows(self, h: int) -> Tuple[int, int]:
        """(first row, map height) of this rank's h rows."""
        return self.rank * h, self.world * h

    def own(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole map [B, H, ...]."""
        h = whole.shape[1] // self.world
        return whole[:, self.rank * h:(self.rank + 1) * h]

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        return _HaloRows.apply(self, x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherRows.apply(self, x)

    def check(self, h: int, stem: int, depth: int) -> None:
        """Refuse a stripe that a stage's 2x downsampling cannot split: h
        local input rows, a stem of `stem`, `depth` stages."""
        if h % stem:
            raise ValueError(f"spatial split over {self.world} ranks: {h} rows per rank "
                             f"do not divide into the stem's {stem}-row patches")
        rows = h // stem
        for i in range(depth):
            if rows == 0 or (i < depth - 1 and rows % 2):
                raise ValueError(
                    f"spatial split over {self.world} ranks: enc_stage_{i} gets {rows} "
                    f"rows per rank of a {rows * self.world}-row map; its 2x "
                    "downsampling needs an even, non-empty stripe on every rank")
            rows //= 2


class SpatialDataParallel(DataParallel):
    """DataParallel over the data axes of a spatial split: the gradients
    and the loss are summed over the model group (each rank's part of the
    loss is its rows' share of the stripe's mean) before the data axes'
    mean, which data axes of one device skip."""

    def __init__(self, device, mesh: Mesh):
        super().__init__(device, **mesh.data_groups())
        self.spatial = SpatialSplit(mesh)

    def __call__(self, grads: Sequence[torch.Tensor]) -> None:
        all_reduce_sum(grads, self.device, self.spatial.group)
        if self.world > 1:
            super().__call__(grads)

    def mean(self, values: torch.Tensor) -> torch.Tensor:
        out = values.detach().to(self.device, torch.float32).clone()
        all_reduce_sum([out], self.device, self.spatial.group)
        return (super().mean(out) if self.world > 1 else out).to(values.device)


def spatial_parallel(unet: nn.Module, mesh: Mesh, device) -> SpatialDataParallel:
    """Run `unet` on this rank's rows of every feature map (its
    `spatial` split; parameters replicated) and return the reducer its
    train step takes (make_ldm_train_step's reduce_grads)."""
    dp = SpatialDataParallel(device, mesh)
    unet.spatial = dp.spatial
    return dp
