"""Logical-axis sharding rules (MaxText-style) with divisibility guards, and
the collectives of a running mesh.

Every parameter and activation dimension carries a *logical* axis name;
rules map logical names to mesh axes. A dimension is sharded only when its
size divides the mesh-axis extent and the mesh axis is not already consumed
by an earlier dimension of the same tensor; otherwise it falls back to
replication (paligemma's kv_heads=1 on a 16-way model axis). The rules, the
guard and the specs are the reference package's ``sharding.py``; a spec is
a plain tuple holding what the reference's ``PartitionSpec`` holds.

A `Mesh` is the mesh's axis names and sizes, so specs are pure logic and
need no process group (`launch.mesh.make_production_mesh` gives the
production shapes without devices). A mesh that runs (`launch.mesh.spawn`:
one process a rank) also holds its ``torch.distributed`` `DeviceMesh` and
this rank's coordinate on each axis; `ShardingCtx` then runs the manual
regions' collectives over an axis's process group (`all_reduce`,
`all_to_all`, `all_gather`, `mean_all`). Every tensor a rank holds is its
own shard: the whole tensor where the spec replicates, its slice
(`local_shard`) where the spec splits it.

The collectives are out of place and differentiable, under one convention,
the *sum* convention: every rank differentiates its share of the global
objective (the objective is the sum of the ranks' shares), so a leaf's
gradient is the sum, over the ranks that compute with it, of what each
rank's backward gives it. Each collective's backward is then its textbook
transpose, itself a collective over the same ranks:

  * ``all_reduce`` (sum)  -> ``all_reduce`` (sum) of the cotangents;
  * ``mean_all``          -> ``all_reduce`` of the cotangents over every
                             rank, divided by their count;
  * ``all_to_all``        -> the ``all_to_all`` back;
  * ``all_gather``        -> reduce-scatter: the cotangents' blocks summed
                             over the axis, in rank order, each rank keeping
                             its own block (an ``all_to_all`` of the blocks,
                             then their sum).

A slice a rank takes of a tensor every rank holds (``x[:, r*s:(r+1)*s]``)
is differentiated by autograd as itself: its cotangent lands in the rank's
block and zeros elsewhere, and the sum over the ranks makes it whole. The
train step (`runtime.steps`) seeds each rank's backward with 1 / (the
number of ranks), its share of the mean that every rank computes, and sums
each leaf's gradient over the axes of the ranks that hold it. ``all_reduce``
with ``max`` (serving's log-sum-exp merge) has no backward.

The parameters are held placed (each leaf split by its partition spec)
while each op computes with coarser blocks (a leaf split only where the op
runs in parallel): `gather_blocks` takes a rank's placed blocks to the
blocks it computes with, and `reduce_blocks` takes each rank's gradient
shares there to the sum's placed block, a reduce-scatter built from an
all_to_all of the blocks as all_gather's backward is. In grad mode
`gather_blocks` is differentiable: its backward is that reduce-scatter
(`reduce_blocks` without the sum over the axes that do not place a leaf),
so a rank's gradient of its placed block is the sum over the ranks that
gathered it. The model (`models.lm`) gathers each layer's blocks just
before the layer, inside its remat, and again in the recompute; serving
gathers with no backward.

`shard_map` is the reference's: the manual regions (the sequence-split
decode, the expert-parallel MoE, the compressed sum) run their bodies
through it on this rank's blocks, each checked against its spec's block
of the whole tensor's shape; `tree_shardings` gives a tree's specs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["AxisVal", "BUCKET_ELEMS", "DEFAULT_RULES", "DryGroup", "Mesh",
           "NULL_CTX", "ShardingCtx", "block_shape", "collective_stats",
           "dry_mesh", "gather_blocks",
           "local_shard", "reduce_blocks", "reset_collective_stats",
           "shard_map", "split_axes", "tree_shardings", "tree_specs"]

AxisVal = Union[None, str, Tuple[str, ...]]

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),   # data parallel (pod extends DP across pods)
    "fsdp": "data",             # ZeRO/FSDP parameter+optimizer storage
    "embed": "data",            # alias of fsdp for embedding-dim storage
    "vocab": "model",           # column-parallel embedding / logits
    "heads": "model",           # tensor-parallel attention heads
    "kv_heads": "model",
    "mlp": "model",             # tensor-parallel FFN width
    "experts": "model",         # expert parallelism
    "kv_seq": "model",          # context parallelism of decode KV caches
    "d_inner": "model",         # SSM inner width tensor parallelism
    "conv_dim": "model",
    # unsharded logical axes
    "layers": None,
    "seq": None,
    "head_dim": None,
    "ssm_state": None,
    "ssm_heads": None,
    "chunk": None,
    "width": None,
    "stack": None,
}


# This process's collectives since the last reset: calls, bytes sent in,
# and (when timed) seconds, each call timed from a device sync before it to
# one after it, so that it holds the collective alone; and the calls and
# bytes (and, when timed, seconds) by kind (``all-reduce``, ``all-to-all``, ``all-gather``: the
# reference's HLO names; the port's reduce-scatters are all_to_alls).
_STATS: Dict[str, Any] = {"calls": 0, "bytes": 0, "s": 0.0, "timed": False,
                          "by_kind": {}}


def reset_collective_stats(*, timed: bool = False) -> None:
    """Zero the counts; `timed` times each collective from here on."""
    _STATS.update(calls=0, bytes=0, s=0.0, timed=bool(timed), by_kind={})


def collective_stats() -> Dict[str, Any]:
    out = dict(_STATS)
    out["by_kind"] = {k: dict(v) for k, v in _STATS["by_kind"].items()}
    return out


class DryGroup:
    """The process group of a dry mesh's line or whole mesh: its size and
    no processes. A collective over it counts, makes its output as a
    running group would (meta tensors of the same shapes) and sends
    nothing."""

    def __init__(self, size: int):
        self.size = size


@contextlib.contextmanager
def _counted(x: torch.Tensor, kind: str):
    nbytes = x.numel() * x.element_size()
    _STATS["calls"] += 1
    _STATS["bytes"] += nbytes
    k = _STATS["by_kind"].setdefault(kind, {"calls": 0, "bytes": 0})
    k["calls"] += 1
    k["bytes"] += nbytes
    if not _STATS["timed"]:
        yield
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    yield
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    dt = time.perf_counter() - t0
    _STATS["s"] += dt
    k["s"] = k.get("s", 0.0) + dt


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: axis names and sizes; when it runs, also the
    `torch.distributed` `DeviceMesh`, this rank's coordinate on each axis
    and this rank's device. A `dry` mesh (`dry_mesh`) is one rank's view
    of a mesh with no processes behind it, for the dry-run's trace on meta
    tensors: a coordinate, no `DeviceMesh`, collectives that count and
    send nothing."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device_mesh: Any = None
    coordinate: Tuple[int, ...] = ()
    device: Optional[torch.device] = None
    dry: bool = False

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape {self.shape} "
                             "differ in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Mesh context handed to models and runtime; ``mesh=None`` takes the
    single-device paths."""

    mesh: Optional[Mesh] = None
    rules: Optional[Dict[str, AxisVal]] = None
    use_shard_map: bool = True  # the manual regions (decode attention, EP)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        if self.mesh is None:
            return {}
        return dict(zip(self.mesh.axis_names, self.mesh.shape))

    def resolved_rules(self) -> Dict[str, AxisVal]:
        rules = dict(DEFAULT_RULES)
        if self.rules:
            rules.update(self.rules)
        # drop mesh axes this mesh lacks (e.g. "pod" on one pod)
        names = set(self.mesh.axis_names) if self.mesh is not None else set()

        def _filter(v: AxisVal) -> AxisVal:
            if v is None:
                return None
            if isinstance(v, str):
                return v if v in names else None
            kept = tuple(a for a in v if a in names)
            return kept if kept else None

        return {k: _filter(v) for k, v in rules.items()}

    def axis_size(self, mesh_axes: AxisVal) -> int:
        if mesh_axes is None or self.mesh is None:
            return 1
        sizes = self.axis_sizes
        if isinstance(mesh_axes, str):
            return sizes[mesh_axes]
        return math.prod(sizes[a] for a in mesh_axes)

    # ------------------------------------------------------------ spec build
    def spec(self, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Tuple[AxisVal, ...]:
        """The partition spec of logical `axes` (guarded by `shape`'s
        divisibility): one entry a dimension, a mesh axis, a tuple of them
        or None, with trailing Nones dropped, as the reference's
        ``PartitionSpec`` holds them."""
        if self.mesh is None:
            return ()
        rules = self.resolved_rules()
        used: set = set()
        entries = []
        for i, name in enumerate(axes):
            mesh_axes = rules.get(name) if name else None
            if mesh_axes is None:
                entries.append(None)
                continue
            tup = (mesh_axes,) if isinstance(mesh_axes, str) \
                else tuple(mesh_axes)
            tup = tuple(a for a in tup if a not in used)
            if not tup:
                entries.append(None)
                continue
            extent = math.prod(self.axis_sizes[a] for a in tup)
            if shape is not None and shape[i] % extent != 0:
                entries.append(None)  # replicate: not evenly divisible
                continue
            used.update(tup)
            entries.append(tup[0] if len(tup) == 1 else tup)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def constrain(self, x, axes: Sequence[Optional[str]]):
        """The reference's sharding constraint: an annotation for its
        compiler. Each rank here already holds its shard, so it is the
        identity."""
        return x

    # --------------------------------------------------------- running mesh
    def index(self, axis: str) -> int:
        """This rank's coordinate on mesh axis `axis` (0 where the mesh
        lacks it)."""
        if self.mesh is None or axis not in self.mesh.axis_names:
            return 0
        self._running()
        return self.mesh.coordinate[self.mesh.axis_names.index(axis)]

    @property
    def device(self) -> Optional[torch.device]:
        return None if self.mesh is None else self.mesh.device

    def _running(self) -> None:
        if self.mesh is not None and self.mesh.dry:
            return
        if self.mesh is None or self.mesh.device_mesh is None:
            raise RuntimeError(
                "this needs a running mesh (one process a rank: "
                "repro_torch.launch.mesh.spawn); this context holds only "
                "the mesh's shape")

    def group(self, axis: str):
        """The process group of this rank's line along mesh axis `axis`."""
        self._running()
        if self.mesh.dry:
            return DryGroup(self.axis_sizes[axis])
        return self.mesh.device_mesh.get_group(axis)

    def _everyone(self):
        """The group of every rank: None (the default group) on a running
        mesh."""
        return DryGroup(self.mesh.size) if self.mesh.dry else None

    def all_reduce(self, x: torch.Tensor, op: str = "sum",
                   axis: str = "model") -> torch.Tensor:
        """``op`` ("sum" or "max") of `x` over mesh axis `axis`: a new
        tensor (`x` itself on an axis of one rank). The sum is
        differentiable (its backward the same sum of the cotangents); the
        max is not, and refuses a tensor that requires grad."""
        if self.axis_sizes.get(axis, 1) == 1:
            return x
        if op == "sum":
            return _AllReduceSum.apply(x, self.group(axis))
        if op != "max":
            raise ValueError(f"all_reduce op is sum or max, got {op!r}")
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("all_reduce max has no backward")
        return _all_reduce(x, "max", self.group(axis))

    def all_to_all(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """``jax.lax.all_to_all(x, axis, 0, 0)``: block i of `x`'s leading
        axis (of size n, the axis's ranks) goes to rank i, and block i of
        the result came from rank i. Its backward is the all_to_all back."""
        n = self.axis_sizes.get(axis, 1)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axis!r} needs a leading axis "
                             f"of {n}, got {tuple(x.shape)}")
        if n == 1:
            return x
        return _AllToAll.apply(x, self.group(axis))

    def all_gather(self, x: torch.Tensor, axis: str = "model",
                   dim: int = 0) -> torch.Tensor:
        """The axis's ranks' `x` concatenated along `dim`, in rank order.
        Its backward is the reduce-scatter of the cotangents."""
        n = self.axis_sizes.get(axis, 1)
        if n == 1:
            return x
        return _AllGather.apply(x, self.group(axis), n, dim)

    def sum_over(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of `x` over the ranks of mesh axes `axes` (a new tensor;
        every axis: the whole mesh; none: `x` itself), with no backward:
        the train step's reduction of the gradients. Every rank of a group
        gets the same bytes."""
        return self._reduce_over(x, axes, "sum")

    def max_over(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """`sum_over` with ``max``: the largest of the ranks' `x`."""
        return self._reduce_over(x, axes, "max")

    def _reduce_over(self, x: torch.Tensor, axes: Sequence[str],
                     op: str) -> torch.Tensor:
        axes = self.live_axes(axes)
        if not axes:
            return x
        return _all_reduce(x, op, self.members(axes)[0])

    def live_axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """`axes` without those of one rank, in the mesh's order."""
        if self.mesh is None:
            return ()
        return tuple(a for a in self.mesh.axis_names
                     if a in axes and self.axis_sizes[a] > 1)

    def members(self, axes: Sequence[str]):
        """(process group, coordinates): the ranks of this rank's group
        over mesh axes `axes` (each of more than one rank), in the group's
        rank order (row-major over the axes, the mesh's order), each as a
        dict axis -> coordinate. Every axis of more than one rank is the
        whole mesh (group None on a running mesh); one axis is its line
        through this rank. A dry mesh takes any set of axes."""
        self._running()
        names = self.mesh.axis_names
        mine = dict(zip(names, self.mesh.coordinate))
        axes = tuple(a for a in names if a in axes)
        coords = [dict(mine, **dict(zip(axes, c))) for c in
                  itertools.product(*(range(self.axis_sizes[a])
                                      for a in axes))]
        if set(axes) == set(self.live_axes(names)):
            return self._everyone(), coords
        if len(axes) == 1:
            return self.group(axes[0]), coords
        if self.mesh.dry:
            return DryGroup(len(coords)), coords
        raise NotImplementedError(f"a group over mesh axes {axes} of "
                                  f"{names}")

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of `x` over every rank of the mesh (the reference's
        ``pmean`` over all axes): a new tensor, differentiable."""
        if self.mesh is None or self.mesh.size == 1:
            return x
        self._running()
        return _AllReduceSum.apply(x, self._everyone()) / self.mesh.size


# ------------------------------------------------------------ the collectives


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` of `x` over `group` (None: every rank), into a new tensor."""
    import torch.distributed as dist
    out = torch.clone(x, memory_format=torch.contiguous_format)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    with _counted(out, "all-reduce"):
        if not isinstance(group, DryGroup):
            dist.all_reduce(out, op=red, group=group)
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    with _counted(x, "all-to-all"):
        if not isinstance(group, DryGroup):
            dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather_parts(x: torch.Tensor, group, n: int):
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    with _counted(x, "all-gather"):
        if not isinstance(group, DryGroup):
            dist.all_gather(parts, x, group=group)
    return parts


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    return torch.cat(_all_gather_parts(x, group, n), dim=dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g, "sum", fctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(fctx, g):
        return _all_to_all(g, fctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group, n, dim):
        fctx.group, fctx.n, fctx.dim = group, n, dim
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(fctx, g):
        # reduce-scatter: block i of every rank's cotangent goes to rank i,
        # which sums the n blocks it receives in rank order
        blocks = torch.stack(g.chunk(fctx.n, dim=fctx.dim))
        return _all_to_all(blocks, fctx.group).sum(0), None, None, None


NULL_CTX = ShardingCtx(mesh=None)


def dry_mesh(mesh: Mesh, coordinate: Optional[Sequence[int]] = None) -> Mesh:
    """`mesh` as one rank of it sees it with no processes behind it (the
    dry-run's): the rank at `coordinate` (default rank 0), meta tensors,
    collectives that count by kind and operand bytes as a running mesh's
    do (`collective_stats`), forward and backward, and send nothing,
    each returning a meta tensor of its output's shape.

    Rank 0's program stands for every rank's, as the reference's SPMD
    module is one program for every device, as long as every split is
    even: each rank then runs the same ops on blocks of the same shapes.
    An uneven split would make rank 0 unrepresentative. The rules never
    make one: a dimension that does not divide its mesh axes is held
    whole by the divisibility guard (`ShardingCtx.spec`), on every rank
    alike, and the dry-run records those leaves (``guard_whole``)."""
    coord = tuple(coordinate) if coordinate is not None else \
        (0,) * len(mesh.shape)
    return Mesh(mesh.axis_names, mesh.shape, coordinate=coord,
                device=torch.device("meta"), dry=True)


def _shard_index(ctx: ShardingCtx, entry: AxisVal) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dimension whose spec
    entry is `entry`: the row-major index over its mesh axes."""
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    idx, n = 0, 1
    for a in axes:
        size = ctx.axis_sizes[a]
        idx = idx * size + ctx.index(a)
        n *= size
    return idx, n


def split_axes(spec: Sequence[AxisVal]) -> Tuple[str, ...]:
    """The mesh axes a partition spec splits its tensor over."""
    axes: Tuple[str, ...] = ()
    for entry in spec:
        if entry is not None:
            axes += (entry,) if isinstance(entry, str) else tuple(entry)
    return axes


def local_shard(x: torch.Tensor, spec: Sequence[AxisVal],
                ctx: ShardingCtx) -> torch.Tensor:
    """The block of the whole tensor `x` that this rank holds under `spec`
    (a view; `x` itself where the spec replicates every dimension)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = _shard_index(ctx, entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} blocks")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def block_shape(shape: Sequence[int], spec: Sequence[AxisVal],
                ctx: ShardingCtx) -> Tuple[int, ...]:
    """The shape of a rank's block of a tensor of `shape` under `spec`."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] //= ctx.axis_size(entry)
    return tuple(out)


# The most elements one collective of `gather_blocks` gathers, or of
# `reduce_blocks` sends: leaves are taken in turn into buckets of at most
# this many (a larger leaf goes alone), so that the transient buffers stay
# a fraction of a large model's state.
BUCKET_ELEMS = 1 << 28


def _entry(spec: Sequence[AxisVal], dim: int) -> AxisVal:
    return spec[dim] if dim < len(spec) else None


def _moved_axes(fine: Sequence[AxisVal], coarse: Sequence[AxisVal],
                ctx: ShardingCtx) -> Tuple[str, ...]:
    """The mesh axes (of more than one rank) that `fine` splits a tensor
    over and `coarse` does not; `coarse` must split each dimension as
    `fine` does or not at all."""
    for dim in range(max(len(fine), len(coarse))):
        c = _entry(coarse, dim)
        if c is not None and c != _entry(fine, dim):
            raise NotImplementedError(
                f"spec {tuple(coarse)} is not {tuple(fine)} with dimensions "
                "left whole")
    kept = set(split_axes(coarse))
    return ctx.live_axes([a for a in split_axes(fine) if a not in kept])


def _within(fine: Sequence[AxisVal], coarse: Sequence[AxisVal],
            coarse_shape: Sequence[int], coord: Dict[str, int],
            ctx: ShardingCtx):
    """Where the block that the rank at `coord` holds under `fine` lies
    inside the block of `coarse_shape` held under `coarse` (the same
    block there): a (dim, start, size) for each dimension that `fine`
    splits and `coarse` does not."""
    out = []
    for dim, entry in enumerate(fine):
        if entry is None or _entry(coarse, dim) == entry:
            continue
        idx, n = 0, 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            idx = idx * ctx.axis_sizes[a] + coord[a]
            n *= ctx.axis_sizes[a]
        size = coarse_shape[dim] // n
        out.append((dim, idx * size, size))
    return out


def _region(x: torch.Tensor, where) -> torch.Tensor:
    for dim, start, size in where:
        x = x.narrow(dim, start, size)
    return x


def _buckets(idx, sizes, cap: int):
    """`idx` cut in turn into runs of at most `cap` in `sizes` (a larger
    one alone)."""
    run, total = [], 0
    for i, n in zip(idx, sizes):
        if run and total + n > cap:
            yield run
            run, total = [], 0
        run.append(i)
        total += n
    if run:
        yield run


def gather_blocks(xs: Sequence[torch.Tensor], fine, coarse,
                  ctx: ShardingCtx) -> List[torch.Tensor]:
    """This rank's blocks of leaves held under specs `fine` -> its blocks
    under the specs `coarse` (a spec a leaf; `coarse` splits each
    dimension as `fine` does or leaves it whole): each leaf gathered over
    the axes that `fine` splits it along and `coarse` does not. The
    leaves gathered over the same axes go through one all_gather a bucket
    of at most `BUCKET_ELEMS` elements gathered; a leaf already held as
    `coarse` wants is returned as it is.

    In grad mode, where a leaf it gathers requires grad, the gather is
    differentiable: its backward is the transpose, the reduce-scatter of
    `reduce_blocks` over the same axes (an all_to_all of the cotangents'
    blocks, summed in rank order in f32, a bucket a collective), so each
    rank's gradient of its block is the sum of the cotangents of every
    rank that gathered it. Otherwise (serving) no backward, and exactly
    these collectives."""
    moved = [i for i, (f, c) in enumerate(zip(fine, coarse))
             if _moved_axes(f, c, ctx)]
    if not (torch.is_grad_enabled()
            and any(xs[i].requires_grad for i in moved)):
        return _gather_blocks(xs, fine, coarse, ctx)
    out = list(xs)
    got = _GatherBlocks.apply(ctx, [fine[i] for i in moved],
                              [coarse[i] for i in moved],
                              *[xs[i] for i in moved])
    for i, y in zip(moved, got):
        out[i] = y
    return out


class _GatherBlocks(torch.autograd.Function):
    """`_gather_blocks` of the leaves it moves, with the reduce-scatter
    back as its backward."""

    @staticmethod
    def forward(fctx, ctx, fine, coarse, *xs):
        fctx.specs = (ctx, fine, coarse)
        return tuple(_gather_blocks(xs, fine, coarse, ctx))

    @staticmethod
    def backward(fctx, *gs):
        ctx, fine, coarse = fctx.specs
        return (None, None, None,
                *_reduce_blocks(gs, coarse, fine, ctx, over_rest=False))


@torch.no_grad()
def _gather_blocks(xs: Sequence[torch.Tensor], fine, coarse,
                   ctx: ShardingCtx) -> List[torch.Tensor]:
    out = list(xs)
    groups: Dict[Tuple[Any, ...], List[int]] = {}
    for i, (x, f, c) in enumerate(zip(xs, fine, coarse)):
        axes = _moved_axes(f, c, ctx)
        if axes:
            groups.setdefault((axes, x.dtype), []).append(i)
    for (axes, _), idx in groups.items():
        group, coords = ctx.members(axes)
        n = len(coords)
        for run in _buckets(idx, [xs[i].numel() * n for i in idx],
                            BUCKET_ELEMS):
            parts = _all_gather_parts(
                torch.cat([xs[i].reshape(-1) for i in run]), group, n)
            off = 0
            for i in run:
                x, k = xs[i], xs[i].numel()
                shape = list(x.shape)
                for dim, entry in enumerate(fine[i]):
                    if entry is not None and _entry(coarse[i], dim) != entry:
                        shape[dim] *= ctx.axis_size(entry)
                y = x.new_empty(shape)
                for part, coord in zip(parts, coords):
                    _region(y, _within(fine[i], coarse[i], shape, coord,
                                       ctx)).copy_(
                        part[off:off + k].view(x.shape))
                out[i] = y
                off += k
    return out


def reduce_blocks(xs: Sequence[torch.Tensor], coarse, fine,
                  ctx: ShardingCtx) -> List[torch.Tensor]:
    """Each rank's shares of leaves computed at specs `coarse` -> this
    rank's block under the specs `fine` of their sum over every rank that
    computes with the same block (the reverse of `gather_blocks`: the
    sum convention's gradients of placed leaves). A leaf's shares are
    summed over the mesh axes that `coarse` does not split it along: over
    those that `fine` splits it along by a reduce-scatter (an all_to_all
    of the blocks, then their sum in rank order: half the bytes of an
    all_reduce and a cut), then over the rest by an all_reduce of the
    block. The leaves of one group of axes go through one collective each
    a bucket of at most `BUCKET_ELEMS` elements, as one f32 buffer; each
    result comes back in its leaf's type. Every rank that holds a block
    gets the same bytes."""
    return _reduce_blocks(xs, coarse, fine, ctx, over_rest=True)


@torch.no_grad()
def _reduce_blocks(xs: Sequence[torch.Tensor], coarse, fine,
                   ctx: ShardingCtx, *, over_rest: bool
                   ) -> List[torch.Tensor]:
    """`reduce_blocks`; without `over_rest`, the reduce-scatter alone (no
    sum over the axes that do not place a leaf): `gather_blocks`'
    backward. A leaf with nothing to sum is returned as it is."""
    out = list(xs)
    groups: Dict[Tuple[Any, ...], List[int]] = {}
    for i, (c, f) in enumerate(zip(coarse, fine)):
        scatter = _moved_axes(f, c, ctx)
        held = set(split_axes(f))
        rest = ctx.live_axes([a for a in ctx.mesh.axis_names
                              if a not in held]) if over_rest else ()
        if scatter or rest:
            groups.setdefault((scatter, rest), []).append(i)
    for (scatter, rest), idx in groups.items():
        group, coords = ctx.members(scatter) if scatter else \
            (None, [dict(zip(ctx.mesh.axis_names, ctx.mesh.coordinate))])
        n = len(coords)
        for run in _buckets(idx, [xs[i].numel() for i in idx],
                            BUCKET_ELEMS):
            wheres = [[_within(fine[i], coarse[i], xs[i].shape, coord, ctx)
                       for coord in coords] for i in run]
            sizes = [_region(xs[i], w[0]).numel()
                     for i, w in zip(run, wheres)]
            buf = torch.empty(n, sum(sizes), dtype=torch.float32,
                              device=xs[run[0]].device)
            off = 0
            for i, w, k in zip(run, wheres, sizes):
                for j in range(n):
                    buf[j, off:off + k].view(_region(xs[i], w[j]).shape) \
                        .copy_(_region(xs[i], w[j]))
                off += k
            red = _all_to_all(buf, group).sum(0) if scatter else buf[0]
            red = ctx.sum_over(red, rest)
            off = 0
            for i, w, k in zip(run, wheres, sizes):
                out[i] = red[off:off + k].view(_region(xs[i], w[0]).shape) \
                    .to(xs[i].dtype)
                off += k
    return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(ctx: ShardingCtx, spec_tree, shape_tree):
    """A nested dict of logical-axes tuples and one of matching shapes ->
    the nested dict of their specs."""
    if _is_axes(spec_tree):
        return ctx.spec(spec_tree, shape_tree)
    return {k: tree_specs(ctx, v, shape_tree[k]) for k, v in spec_tree.items()}


def tree_shardings(ctx: ShardingCtx, spec_tree, shape_tree):
    """`tree_specs` on a mesh, None without one (the reference's
    ``tree_shardings``: its `NamedSharding`s are the specs here)."""
    if ctx.mesh is None:
        return None
    return tree_specs(ctx, spec_tree, shape_tree)


def _check_block(name: str, x, spec, whole, ctx: ShardingCtx) -> None:
    """Raise ValueError unless `x` (a tensor, or a dict of them with dicts
    of specs and of whole shapes) is this rank's block under `spec` of a
    tensor of shape `whole` (a None dimension, or a None `whole`, is not
    checked)."""
    if whole is None or x is None:
        return
    if isinstance(x, dict):
        for k, v in x.items():
            _check_block(f"{name}[{k!r}]", v, spec[k] if isinstance(
                spec, dict) else spec, whole.get(k), ctx)
        return
    want = block_shape([1 if w is None else w for w in whole], spec, ctx)
    got = tuple(x.shape)
    if len(got) != len(whole) or any(
            w is not None and g != b for g, w, b in zip(got, whole, want)):
        shown = tuple("?" if w is None else b for w, b in zip(whole, want))
        raise ValueError(f"shard_map argument {name!r}: a block of shape "
                         f"{got}, where spec {tuple(spec)} of a tensor of "
                         f"{tuple(whole)} gives blocks of {shown}")


def shard_map(fn, *, ctx: ShardingCtx, in_specs, out_specs):
    """The reference's ``shard_map`` where every rank already holds its
    blocks: the returned function runs `fn` on this rank's blocks as they
    are, and adds no collective (the body's own are its collectives).

    It is called with the blocks, and, as ``whole=``, the shapes of the
    whole tensors they are blocks of: one a positional argument, None for
    one not checked, a None dimension for a dimension the rank does not
    know (the batch's rows), a dict for a dict of tensors. A block whose
    shape is not `block_shape` of its whole under its spec of `in_specs`
    raises ValueError naming the argument, before `fn` runs. `fn`'s
    result has one entry a spec of `out_specs` (a tuple of them for a
    tuple result), each output this rank's block under it."""
    import inspect

    try:
        names = [p.name for p in inspect.signature(fn).parameters.values()]
    except (TypeError, ValueError):
        names = []

    def mapped(*args, whole=None):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments for "
                             f"{len(in_specs)} in_specs")
        for i, (x, spec) in enumerate(zip(args, in_specs)):
            name = names[i] if i < len(names) else f"argument {i}"
            _check_block(name, x, spec, None if whole is None else whole[i],
                         ctx)
        out = fn(*args)
        if isinstance(out_specs, list) or (isinstance(out_specs, tuple) and
                                           not _is_axes(out_specs)):
            if not isinstance(out, tuple) or len(out) != len(out_specs):
                raise ValueError(f"shard_map: {len(out_specs)} out_specs "
                                 f"for a result of {type(out).__name__}")
        return out

    mapped.in_specs, mapped.out_specs = tuple(in_specs), out_specs
    return mapped
