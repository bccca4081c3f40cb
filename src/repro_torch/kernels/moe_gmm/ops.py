"""Public grouped-matmul op.

``depth=None`` solves the number of in-flight weight slices from the
declared `CoroSpec` (`moe_gmm.gmm_spec`) through core.autotune.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.moe_gmm.moe_gmm import F_TILE, gmm

__all__ = ["moe_gmm"]


def moe_gmm(tokens: torch.Tensor, weights: torch.Tensor, *,
            f_tile: int = F_TILE, depth: Optional[int] = None) -> torch.Tensor:
    return gmm(tokens, weights, f_tile=f_tile, depth=depth)
