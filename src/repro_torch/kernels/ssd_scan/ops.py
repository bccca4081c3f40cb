"""Public SSD-scan op.

``depth=None`` solves the number of in-flight chunk loads from the declared
`CoroSpec` (`ssd_scan.ssd_spec`) through core.autotune: the sequential
recurrent state is one copy regardless of depth, so it caps the budget
once, not per slot.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan

__all__ = ["ssd"]


def ssd(x, dt, A, B, C, *, chunk: int = 64, depth: Optional[int] = None):
    """Batched SSD. x:[b,s,nh,p] dt:[b,s,nh] A:[nh] B,C:[b,s,n]."""
    return ssd_scan(x, dt, A, B, C, chunk=chunk, depth=depth)
