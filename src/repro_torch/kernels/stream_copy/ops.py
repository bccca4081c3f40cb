"""Public STREAM-triad op.

``depth=None`` solves the pipeline depth from the declared `CoroSpec`
(`stream_copy.triad_spec`) through core.autotune.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.stream_copy.stream_copy import triad

__all__ = ["stream_triad"]


def stream_triad(b: torch.Tensor, c: torch.Tensor, scalar, *, rows: int = 128,
                 depth: Optional[int] = None) -> torch.Tensor:
    return triad(b, c, scalar, rows=rows, depth=depth)
