"""Int8 gradient compression with error feedback (EF-SGD style): the
reference package's ``optim/compression.py``.

Per-tensor max-abs scaling to int8, with the quantization residual fed
back into the next step so that the long-run bias vanishes. The train
step runs `ef_compress_`, the in-place `ef_compress`, when
``compress_grads=True`` (it models the wire format); on a mesh it runs on
the rank's blocks of the reduced gradients, and a leaf's scale is its
whole max: each rank's block max, then the largest over the axes that
split the leaf (one ``max`` all_reduce a group of leaves split alike), so
that every rank quantizes with the scale the reference takes of the whole
leaf. `compressed_psum` is the reference's quantized all-reduce over one
mesh axis: quantize locally, sum the int8 values as int32 over the axis,
dequantize with the largest of the ranks' scales. As in the reference,
nothing on the train path calls it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.core import tree
from repro_torch.sharding import NULL_CTX, ShardingCtx, shard_map, split_axes

__all__ = ["compressed_psum", "dequantize_int8", "ef_compress",
           "ef_compress_", "init_error_state", "quantize_int8"]


def _whole_max(amax: List[torch.Tensor], ctx: ShardingCtx,
               specs) -> List[torch.Tensor]:
    """Each leaf's max|x| of this rank's block -> of the whole leaf: on a
    mesh (`specs`: the blocks' partition specs) the largest over the axes
    that split it, one all_reduce for the leaves split over the same
    axes."""
    if ctx.mesh is None or specs is None:
        return amax
    amax = list(amax)
    groups: Dict[Tuple[str, ...], List[int]] = {}
    for i, spec in enumerate(specs):
        axes = ctx.live_axes(split_axes(spec))
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        whole = ctx.max_over(torch.stack([amax[i] for i in idx]), axes)
        for i, m in zip(idx, whole.unbind()):
            amax[i] = m
    return amax


def _quantize(x: torch.Tensor, amax: torch.Tensor):
    scale = amax / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor, ctx: ShardingCtx = NULL_CTX,
                  spec=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): round-half-even of x / scale, clipped to
    +-127, with scale = max|x| / 127 (+1e-30). On a mesh `x` is this
    rank's block of a leaf held under `spec`, and the max is the whole
    leaf's."""
    amax = _whole_max([torch.max(torch.abs(x))], ctx, [spec])[0]
    return _quantize(x, amax)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compress_leaves(grads, error_state, ctx: ShardingCtx, specs):
    """Leaf by leaf: (decompressed g in g's type, the new f32 error). The
    maxima come first, then each leaf's g + e again, so that no more than
    one leaf's f32 copies are alive at a time."""
    gs, es = tree.leaves(grads), tree.leaves(error_state)
    amax = _whole_max([torch.max(torch.abs(g.float() + e))
                       for g, e in zip(gs, es)], ctx,
                      None if specs is None else tree.leaves(specs))
    for g, e, m in zip(gs, es, amax):
        x = g.float() + e
        dq = dequantize_int8(*_quantize(x, m))
        yield dq.to(g.dtype), x - dq


@torch.no_grad()
def ef_compress(grads, error_state, ctx: ShardingCtx = NULL_CTX,
                specs=None):
    """Error-feedback compression: returns (decompressed grads in each
    gradient's type, the new f32 error state). On a mesh (`ctx`, and
    `specs`: the partition specs of the blocks of `grads` this rank
    holds) each leaf is quantized with its whole max."""
    out = list(_compress_leaves(grads, error_state, ctx, specs))
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))


@torch.no_grad()
def ef_compress_(grads, error_state, ctx: ShardingCtx = NULL_CTX,
                 specs=None):
    """`ef_compress` with the new error written into `error_state`'s own
    tensors (the train step's CUDA graph keeps no second error state).
    Returns the decompressed grads."""
    out = []
    for e, (dq, err) in zip(tree.leaves(error_state),
                            _compress_leaves(grads, error_state, ctx, specs)):
        e.copy_(err)
        out.append(dq)
    return tree.unflatten(grads, out)


def init_error_state(params):
    return tree.map_tree(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


@torch.no_grad()
def compressed_psum(x: torch.Tensor, ctx: ShardingCtx,
                    axis: str) -> torch.Tensor:
    """The sum of `x` over mesh axis `axis` through int8 (the reference's
    ``compressed_psum`` in a ``shard_map``): each rank quantizes its `x`,
    the int8 values are summed as int32 over the axis (exact for up to
    2^23 ranks), and the sum is dequantized with the largest of the ranks'
    scales. Returns a new tensor in `x`'s type, the same on every rank of
    the axis. The body runs through `sharding.shard_map` on the rank's
    block, as the reference runs it inside one."""

    def body(x):
        q, scale = quantize_int8(x.float())
        total = ctx.all_reduce(q.to(torch.int32), "sum", axis)
        scale = ctx.all_reduce(scale, "max", axis)
        return dequantize_int8(total, scale).to(x.dtype)

    return shard_map(body, ctx=ctx, in_specs=((),), out_specs=())(x)
