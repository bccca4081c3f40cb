"""Int8 gradient compression with error feedback (EF-SGD style): the
reference package's ``optim/compression.py``.

Per-tensor max-abs scaling to int8, with the quantization residual fed
back into the next step so that the long-run bias vanishes. The train
step runs `ef_compress_`, the in-place `ef_compress`, when
``compress_grads=True`` (it models the wire format); on a mesh it runs on
the reduced gradients. `compressed_psum` is the reference's quantized
all-reduce over one mesh axis: quantize locally, sum the int8 values as
int32 over the axis, dequantize with the largest of the ranks' scales.
As in the reference, nothing on the train path calls it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree
from repro_torch.sharding import ShardingCtx

__all__ = ["compressed_psum", "dequantize_int8", "ef_compress",
           "ef_compress_", "init_error_state", "quantize_int8"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): round-half-even of x / scale, clipped to
    +-127, with scale = max|x| / 127 (+1e-30)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compress_leaf(g, e):
    """(decompressed g in g's type, the new f32 error) of one leaf."""
    g32 = g.float() + e
    q, s = quantize_int8(g32)
    dq = dequantize_int8(q, s)
    return dq.to(g.dtype), g32 - dq


@torch.no_grad()
def ef_compress(grads, error_state):
    """Error-feedback compression: returns (decompressed grads in each
    gradient's type, the new f32 error state)."""
    out = [_compress_leaf(g, e) for g, e in zip(tree.leaves(grads),
                                                tree.leaves(error_state))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))


@torch.no_grad()
def ef_compress_(grads, error_state):
    """`ef_compress` with the new error written into `error_state`'s own
    tensors (the train step's CUDA graph keeps no second error state).
    Returns the decompressed grads."""
    out = []
    for g, e in zip(tree.leaves(grads), tree.leaves(error_state)):
        dq, err = _compress_leaf(g, e)
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
    the axis."""
    q, scale = quantize_int8(x.float())
    total = ctx.all_reduce(q.to(torch.int32), "sum", axis)
    scale = ctx.all_reduce(scale, "max", axis)
    return dequantize_int8(total, scale).to(x.dtype)
