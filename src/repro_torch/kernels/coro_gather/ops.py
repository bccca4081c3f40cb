"""Public ops for the coroutine gather: padding, coalescing, auto-depth.

``depth=None`` on either entry point solves the pipeline depth from the
declared `CoroSpec` through core.autotune (capped by the classified context
bytes against the machine's shared memory; adaptive once transfer samples
are recorded — see autotune.record_transfer). The coalesced path threads
the same auto-depth into both sub-pipelines.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.descriptors import GatherPlan, plan_gather
from repro_torch.kernels.coro_gather.coro_gather import row_gather, span_gather

__all__ = ["coalesced_gather", "coro_gather", "padded_indices"]


def _indices(idx, device) -> torch.Tensor:
    """An int32 index tensor on `device` from a tensor or host array."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(idx, np.int32), device=device)


def padded_indices(idx, device, rows_per_tile: int) -> torch.Tensor:
    """`row_gather`'s index operand: `idx` as int32 on `device`, padded with
    row 0 to a multiple of `rows_per_tile`."""
    idx = _indices(idx, device)
    pad = (-idx.shape[0]) % rows_per_tile
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
    return idx


def coro_gather(table: torch.Tensor, idx, *, depth: Optional[int] = None,
                rows_per_tile: int = 8) -> torch.Tensor:
    """Pipelined gather; pads the index stream to a tile multiple (with
    row 0) and drops the padding rows from the result."""
    n = len(idx)
    out = row_gather(table, padded_indices(idx, table.device, rows_per_tile),
                     depth=depth, rows_per_tile=rows_per_tile)
    return out[:n]


def coalesced_gather(table: torch.Tensor, idx, *, span: int = 8,
                     depth: Optional[int] = None
                     ) -> Tuple[torch.Tensor, GatherPlan]:
    """Coalesced gather (paper §III-C): span copies + single-row leftovers.

    `idx` is host data (the plan is a compile-time pass, like the paper's
    greedy basic-block scheduling); a tensor is copied to the host first.
    Returns (out, plan) so callers can report the coalescing ratio. Each
    sub-pipeline solves its own depth when `depth` is None (span tiles and
    row tiles have different specs).
    """
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    plan = plan_gather(np.asarray(idx), span=span)
    d = table.shape[1]
    parts = []
    if plan.n_spans:
        parts.append(span_gather(table, _indices(plan.span_starts,
                                                 table.device),
                                 span=span, depth=depth))
    if plan.n_singles:
        parts.append(coro_gather(table, plan.singles,
                                 rows_per_tile=min(8, max(plan.n_singles, 1)),
                                 depth=depth))
    if not parts:
        return table.new_zeros((0, d)), plan
    flat = torch.cat(parts, dim=0)
    order = torch.as_tensor(plan.order.astype(np.int64), device=table.device)
    return flat[order], plan
