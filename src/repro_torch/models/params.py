"""Parameter declaration: shapes + logical axes + initializers in one tree.

Models declare a nested dict of ``ParamSpec``; the tree can then be made
into meta tensors (`abstract`: shapes and types, no memory), into real
tensors on a device from a seeded `torch.Generator` (`initialize`), or
into partition specs (`partition_specs`, through a `sharding.ShardingCtx`),
and `params_from_numpy` takes the reference package's parameters (its
pytree with numpy leaves) across with the same names and shapes. On a mesh
each rank holds the shard of every parameter that `held_specs` gives
(`local_params`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import NULL_CTX, ShardingCtx, block_shape, \
    local_shard

__all__ = ["ParamSpec", "abstract", "count", "held_specs", "initialize",
           "is_spec", "local_params", "map_specs", "params_from_numpy",
           "partition_specs", "placed_params", "shardings", "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "float32"
    init: str = "normal"  # normal | zeros | ones | fan_in
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch.dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def map_specs(fn: Callable[[ParamSpec], Any], tree):
    """Apply `fn` to every spec of a nested dict, keeping its structure."""
    if is_spec(tree):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    if is_spec(tree):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, f"{prefix}.{k}" if prefix else k)


def count(tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(tree))


def abstract(tree):
    """Meta tensors of every spec's shape and type (no memory): the
    reference's ShapeDtypeStruct tree."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                           device="meta"), tree)


def partition_specs(tree, ctx: ShardingCtx):
    """Every spec's partition spec under `ctx`'s rules (a tuple a leaf)."""
    return map_specs(lambda s: ctx.spec(s.axes, s.shape), tree)


def shardings(tree, ctx: ShardingCtx):
    """`partition_specs` on a mesh, None without one (the reference's
    ``shardings``: its `NamedSharding`s are the specs here)."""
    if ctx.mesh is None:
        return None
    return partition_specs(tree, ctx)


def held_specs(tree, cfg, ctx: ShardingCtx):
    """What each rank holds of every parameter on the serving path, as a
    partition spec a leaf: the reference places no weight there, so every
    leaf is whole, except a MoE layer's experts inside its expert-parallel
    regions (`models.moe.EXPERT_SPECS`, on the stacked leaf's experts
    axis) when the layer takes them (`models.moe.ep_sharded`)."""
    from repro_torch.models.moe import EXPERT_SPECS, ep_sharded

    split = ep_sharded(cfg, ctx)

    def walk(node, path):
        if is_spec(node):
            if split and len(path) >= 2 and path[-2] == "moe" \
                    and EXPERT_SPECS.get(path[-1]):
                lead = node.axes.index("experts")
                return (None,) * lead + EXPERT_SPECS[path[-1]]
            return ()
        return {k: walk(v, path + (k,)) for k, v in node.items()}

    return walk(tree, ())


def local_params(params, cfg, ctx: ShardingCtx):
    """The whole parameters -> this rank's (`held_specs`): a split leaf is
    copied out of the whole one (which the caller may then free), a whole
    one is the same tensor."""
    from repro_torch.models.lm import param_specs

    def take(x, spec):
        return local_shard(x, spec, ctx).clone() if spec else x

    def walk(node, specs):
        if isinstance(node, dict):
            return {k: walk(v, specs[k]) for k, v in node.items()}
        return take(node, specs)

    return walk(params, held_specs(param_specs(cfg), cfg, ctx))


def placed_params(params, cfg, ctx: ShardingCtx):
    """The whole parameters -> this rank's blocks of them placed by their
    rules (`partition_specs`, the train state's layout on a mesh; a
    dimension that does not divide its mesh axis stays whole, by the
    guard of `ShardingCtx.spec`): a split leaf is copied out of the whole
    one (which the caller may then free), a whole one is the same
    tensor."""
    from repro_torch.models.lm import param_specs

    def walk(node, specs):
        if isinstance(node, dict):
            return {k: walk(v, specs[k]) for k, v in node.items()}
        return local_shard(node, specs, ctx).clone() if specs else node

    return walk(params, partition_specs(param_specs(cfg), ctx))


def _fan_in_scale(s: ParamSpec) -> float:
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    return 1.0 / float(np.sqrt(max(fan_in, 1)))


def initialize(spec_tree, generator: torch.Generator, device, *,
               ctx: ShardingCtx = NULL_CTX) -> Dict[str, Any]:
    """Materialize real parameter tensors on `device`, one leaf at a time.

    normal / fan_in leaves are drawn in f32 from `generator` (which must
    live on `device`) and cast to the spec's dtype; a stacked ``[L, ...]``
    leaf is drawn one layer slice at a time, so the transient f32 copy is
    one layer, not the whole stack. On a mesh (`ctx`) each leaf is this
    rank's block of it placed by its rules (`partition_specs`): every
    slice is drawn whole and cut, so the numbers are those of
    `placed_params` of the whole draw, and a rank never holds a whole
    stacked leaf. The numbers differ from the reference package's (a
    torch generator is not a jax key); tests that compare the two
    packages bridge the reference's parameters with `params_from_numpy`.
    """
    device = torch.device(device)

    def make(s: ParamSpec) -> torch.Tensor:
        dt = torch_dtype(s.dtype)
        spec = ctx.spec(s.axes, s.shape)
        shape = block_shape(s.shape, spec, ctx)
        if s.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        scale = _fan_in_scale(s) if s.init == "fan_in" else s.scale
        out = torch.empty(shape, dtype=dt, device=device)
        stacked = len(s.shape) >= 3
        slices = out if stacked else out[None]
        part_shape = s.shape[1:] if stacked else s.shape
        part_spec = spec[1:] if stacked else spec
        for part in slices:
            draw = torch.randn(part_shape, generator=generator,
                               dtype=torch.float32, device=device)
            part.copy_(local_shard(draw, part_spec, ctx).mul_(scale))
        return out

    return map_specs(make, spec_tree)


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16; widen exactly
        a = a.astype(np.float32)
    # a copy: the reference's arrays are read-only views
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def params_from_numpy(tree, cfg, device,
                      ctx: ShardingCtx = NULL_CTX) -> Dict[str, Any]:
    """The reference package's parameters -> the port's.

    `tree` is the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, model.init(key))``). Returns a nested dict
    of tensors on `device` with the same names and shapes, each cast to the
    port's declared dtype for `cfg` and, on a mesh, cut to this rank's
    shard (`local_params`); a missing, extra or misshapen leaf raises
    ValueError."""
    from repro_torch.models.lm import param_specs

    specs = param_specs(cfg)
    seen = set()

    def take(path: Tuple[str, ...], s: ParamSpec) -> torch.Tensor:
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                raise ValueError(f"reference params lack {'.'.join(path)}")
            node = node[k]
        a = np.asarray(node)
        if tuple(a.shape) != tuple(s.shape):
            raise ValueError(f"{'.'.join(path)}: shape {a.shape} != "
                             f"{s.shape}")
        seen.add(path)
        return _to_tensor(a, torch_dtype(s.dtype), device)

    def walk(spec, path):
        if is_spec(spec):
            return take(path, spec)
        return {k: walk(v, path + (k,)) for k, v in spec.items()}

    out = walk(specs, ())
    extra = {p for p, _ in _numpy_leaves(tree)} - seen
    if extra:
        raise ValueError(f"reference params have leaves the port does not "
                         f"declare: {sorted('.'.join(p) for p in extra)}")
    return out if ctx.mesh is None else local_params(out, cfg, ctx)


def _numpy_leaves(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numpy_leaves(v, prefix + (k,))
    else:
        yield prefix, tree
