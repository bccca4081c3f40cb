"""Public scatter-add op: dedup (await/asignal analogue) + pipelined RMW."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.descriptors import dedup_rmw
from repro_torch.kernels.coro_scatter_add.coro_scatter_add import (
    scatter_add_unique,
)

__all__ = ["coro_scatter_add", "rmw_operands"]


def _host(x) -> np.ndarray:
    """A host numpy array of a tensor or array; bf16 goes through float32,
    which numpy has."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def rmw_operands(table: torch.Tensor, idx, updates, rows_per_tile: int):
    """`scatter_add_unique`'s (idx, updates) operands on the table's device:
    duplicates of `idx` combined (`dedup_rmw`, on the host), then padded to
    a multiple of `rows_per_tile` with distinct rows no update targets, each
    with a zero update, so that a padding row can never race a real one.
    Duplicates of bf16 updates are summed in float32 (numpy has no bf16)."""
    uniq, summed = dedup_rmw(_host(idx), _host(updates))
    pad = (-uniq.shape[0]) % rows_per_tile
    if pad:
        unused = np.setdiff1d(np.arange(table.shape[0]), uniq)[:pad]
        if unused.shape[0] < pad:
            raise ValueError("cannot pad: every row is a scatter target")
        uniq = np.concatenate([uniq, unused.astype(uniq.dtype)])
        summed = np.concatenate(
            [summed, np.zeros((pad,) + summed.shape[1:], summed.dtype)])
    return (torch.as_tensor(uniq.astype(np.int32), device=table.device),
            torch.as_tensor(summed, device=table.device).to(table.dtype))


def coro_scatter_add(table: torch.Tensor, idx, updates, *,
                     depth: Optional[int] = None,
                     rows_per_tile: int = 8) -> torch.Tensor:
    """table[idx[i]] += updates[i] with duplicates combined up front; returns
    a new table and leaves `table` as it was (the reference's functional
    result: the clone is a plain copy, then the kernel updates it in place).

    The dedup is the compile-time replacement for the paper's await/asignal
    coroutine locks: after it, no two in-flight slots can target the same
    row, so the RMW pipeline is race-free by construction. `idx` and
    `updates` are host data for the pass (tensors are copied to the host).
    Duplicates of bf16 updates are summed in float32 and rounded once,
    where the reference sums them in bf16: the two agree within bf16's
    3e-2 tolerance.
    """
    uniq, summed = rmw_operands(table, idx, updates, rows_per_tile)
    return scatter_add_unique(table.clone(), uniq, summed, depth=depth,
                              rows_per_tile=rows_per_tile)
