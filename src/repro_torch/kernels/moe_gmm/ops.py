"""Public grouped-matmul op, differentiable through the kernel itself.

``depth=None`` solves the number of in-flight weight slices from the
declared `CoroSpec` (`moe_gmm.gmm_spec`) through core.autotune; a given
depth serves the forward and both backward products.

`moe_gmm` is a `torch.autograd.Function` around `gmm`. For
``out[e] = tokens[e] @ weights[e]`` the backward runs two grouped matmuls
of the same form, each one more `gmm` call (so on CUDA tensors the kernel,
under the guard, and on CPU tensors its plain version: the CPU exercises
the formula the card runs):

* ``d tokens[e] = d out[e] @ weights[e]^T``, with the weights transposed
  into a contiguous ``[E, f, dm]`` block (the kernel wants contiguous
  weights);
* ``d weights[e] = tokens[e]^T @ d out[e]``, with ``d out`` as the
  weights and the tokens transposed into ``[E, dm, C]``. A token block
  shared by every expert (a leading 1, or expert stride 0) is transposed
  once and expanded at expert stride 0.

Tokens given with a leading 1 are broadcast over the experts as a stride-0
view, never copied, and their gradient is the sum over the experts, in
f32. Double backward is not supported.

Under the ``"dots"`` remat policy (`models.lm`) the grouped product is one
of the saved matmuls: `saving_products` gives the two contexts of a
checkpointed layer, the forward's keeping each product's output and the
recompute's handing them back in order instead of launching again.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.moe_gmm.moe_gmm import F_TILE, gmm

__all__ = ["moe_gmm", "saving_products"]

# the innermost saving context: ("store" | "replay", its outputs, [next])
_SAVING: List[tuple] = []


def saving_products():
    """(store, replay): context managers sharing one list. Inside `store`
    every grouped product's output is kept, in call order; inside
    `replay` the i-th product returns the i-th kept output (no launch)."""
    kept: List[torch.Tensor] = []

    @contextlib.contextmanager
    def mode(name):
        _SAVING.append((name, kept, [0]))
        try:
            yield
        finally:
            _SAVING.pop()

    return mode("store"), mode("replay")


def _product(tokens, weights, f_tile, depth):
    if not _SAVING:
        return gmm(tokens, weights, f_tile=f_tile, depth=depth)
    name, kept, nxt = _SAVING[-1]
    if name == "replay":
        nxt[0] += 1
        return kept[nxt[0] - 1]
    out = gmm(tokens, weights, f_tile=f_tile, depth=depth)
    kept.append(out.detach())
    return out


class _GroupedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tokens, weights, f_tile, depth):
        e = weights.shape[0]
        xs = tokens.expand(e, -1, -1) if tokens.shape[0] == 1 else tokens
        ctx.save_for_backward(tokens, weights)
        ctx.depth = depth
        return _product(xs, weights, f_tile, depth)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        tokens, weights = ctx.saved_tensors
        e = weights.shape[0]
        d_out = d_out.contiguous()
        d_tokens = d_weights = None
        if ctx.needs_input_grad[0]:
            d_tokens = gmm(d_out, weights.transpose(1, 2).contiguous(),
                           depth=ctx.depth)
            if tokens.shape[0] == 1 and e > 1:
                d_tokens = d_tokens.float().sum(0, keepdim=True).to(
                    tokens.dtype)
        if ctx.needs_input_grad[1]:
            if tokens.shape[0] == 1 or tokens.stride(0) == 0:   # shared
                t_t = tokens[0].t().contiguous()[None].expand(e, -1, -1)
            else:
                t_t = tokens.transpose(1, 2).contiguous()
            d_weights = gmm(t_t, d_out, depth=ctx.depth)
        return d_tokens, d_weights, None, None


def moe_gmm(tokens: torch.Tensor, weights: torch.Tensor, *,
            f_tile: int = F_TILE, depth: Optional[int] = None) -> torch.Tensor:
    """tokens [E or 1, C, dm] @ weights [E, dm, f] -> [E, C, f] through
    `gmm`, with gradients for both operands (the backward's products are
    `gmm` calls too)."""
    return _GroupedMatmul.apply(tokens, weights, f_tile, depth)
