"""Public SSD-scan op, differentiable through the backward kernel.

``depth=None`` solves the number of in-flight chunk loads from the declared
`CoroSpec` (`ssd_scan.ssd_spec`) through core.autotune: the sequential
recurrent state is one copy regardless of depth, so it caps the budget
once, not per slot. The backward solves its own depth from
`ssd_scan.ssd_bwd_spec`.

`ssd` is a `torch.autograd.Function` around `ssd_scan`: its backward is
one `ssd_scan_bwd` call (on CUDA tensors the backward kernel, under the
guard; on CPU tensors its plain version, so the CPU exercises the formula
the card runs). y and h_final are both outputs; an upstream gradient that
is None (h_final's in training) is taken as zero without a tensor of
zeros. Double backward is not supported.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd

__all__ = ["ssd"]


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, depth):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B, C, chunk=chunk, depth=depth)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_final):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC = ssd_scan_bwd(x, dt, A, B, C, dy, dh_final,
                                           chunk=ctx.chunk)
        return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC, None, None


def ssd(x, dt, A, B, C, *, chunk: int = 64, depth: Optional[int] = None):
    """Batched SSD from a zero state. x:[b,s,nh,p] dt:[b,s,nh] A:[nh]
    B,C:[b,s,n]. Returns (y, h_final) as `ssd_scan`, with gradients for
    x, dt, A, B and C through `ssd_scan_bwd`."""
    return _SSDScan.apply(x, dt, A, B, C, chunk, depth)
