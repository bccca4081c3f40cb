"""Int8 gradient compression with error feedback (EF-SGD style): the
reference package's ``optim/compression.py`` on one device.

Per-tensor max-abs scaling to int8, with the quantization residual fed
back into the next step so that the long-run bias vanishes. The train
loop's graph step runs `ef_compress_`, the in-place `ef_compress`, when
``compress_grads=True`` (it models the wire format). The reference's
``compressed_psum``, the quantized all-reduce over a mesh axis, needs a
process group and comes with the multi-device work (ROADMAP Queue 1,
"Multi-device").
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree

__all__ = ["dequantize_int8", "ef_compress", "ef_compress_",
           "init_error_state", "quantize_int8"]


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
