"""Request planning: coalescing and RMW dedup (CoroAMU §III-C / §III-E).

The paper's compiler merges memory requests two ways:
  1. coarse-grained: spatially-adjacent accesses become one up-to-4KB request
     (granularity in high address bits);
  2. `aset`: n independent requests bound to one ID, completing together.

Copies have static shapes, so coalescing quantizes: runs of >= span rows
become fixed-size span copies; the remainder stays as single-row requests
grouped `aset`-style under one copy group. The planner below is the
host-side pass; kernels/coro_gather consumes its plan.

`dedup_rmw` is the compile-time replacement for the paper's await/asignal
locks: duplicate read-modify-write targets are pre-combined (sort +
segment-sum) so each row is written exactly once and slots can never race.

Pure numpy, the same code as the reference package's
``repro/core/descriptors.py`` so that both plan and dedup identically.
numpy has no bfloat16: callers with bf16 updates sum them in float32
(`kernels.coro_scatter_add.ops`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Coalesced gather: `span_starts[i]` covers rows [start, start+span);
    `singles` are the remaining row ids; `order` maps concat(spans*span,
    singles) positions back to the original request order."""

    span: int
    span_starts: np.ndarray   # [n_spans] int32
    singles: np.ndarray       # [n_singles] int32
    order: np.ndarray         # [n_requests] int32 permutation into outputs
    n_requests: int

    @property
    def n_spans(self) -> int:
        return int(self.span_starts.shape[0])

    @property
    def n_singles(self) -> int:
        return int(self.singles.shape[0])

    def requests_issued(self) -> int:
        return self.n_spans + self.n_singles

    def coalescing_ratio(self) -> float:
        return self.requests_issued() / max(self.n_requests, 1)


def plan_gather(indices: np.ndarray, *, span: int = 8) -> GatherPlan:
    """Greedy span coalescing of a gather index stream.

    Detects maximal runs of consecutive row ids (in sorted order) and carves
    them into fixed-`span` DMAs; everything else is a single-row request.
    Duplicate ids are NOT deduped (a gather may legitimately re-read a row);
    they simply never coalesce with themselves.
    """
    idx = np.asarray(indices, np.int64)
    n = idx.shape[0]
    if n == 0:
        return GatherPlan(span, np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.int32), 0)
    order = np.argsort(idx, kind="stable")
    s = idx[order]
    # run boundaries: value not exactly previous+1
    new_run = np.ones(n, bool)
    new_run[1:] = s[1:] != s[:-1] + 1
    run_id = np.cumsum(new_run) - 1
    run_start_pos = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start_pos, n))

    out_pos_sorted = np.empty(n, np.int64)  # output slot per sorted position
    span_starts = []
    singles = []
    for rs, rl in zip(run_start_pos, run_len):
        full = rl // span
        for k in range(full):
            base = len(span_starts) * span
            span_starts.append(int(s[rs + k * span]))
            for j in range(span):
                out_pos_sorted[rs + k * span + j] = base + j
        for j in range(full * span, rl):
            singles.append(int(s[rs + j]))
            out_pos_sorted[rs + j] = -len(singles)  # placeholder (negative)
    n_span_rows = len(span_starts) * span
    # fix single positions now that span count is known
    neg = out_pos_sorted < 0
    out_pos_sorted[neg] = n_span_rows + (-out_pos_sorted[neg] - 1)

    order_out = np.empty(n, np.int64)
    order_out[order] = out_pos_sorted  # original request i -> output row
    return GatherPlan(
        span,
        np.asarray(span_starts, np.int32),
        np.asarray(singles, np.int32),
        order_out.astype(np.int32),
        n,
    )


def apply_plan_reference(plan: GatherPlan, table: np.ndarray) -> np.ndarray:
    """Oracle: execute the plan with numpy (tests compare vs direct gather)."""
    parts = []
    for st in plan.span_starts:
        parts.append(table[st: st + plan.span])
    if plan.n_singles:
        parts.append(table[plan.singles])
    if parts:
        flat = np.concatenate(parts, axis=0)
    else:
        flat = np.zeros((0,) + table.shape[1:], table.dtype)
    return flat[plan.order]


def dedup_rmw(indices: np.ndarray, updates: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Combine duplicate RMW targets (await/asignal -> compile-time transform).

    Returns (unique_indices, summed_updates) such that a scatter-add of the
    result equals a scatter-add of the input, with each row touched once.
    """
    idx = np.asarray(indices)
    upd = np.asarray(updates)
    uniq, inv = np.unique(idx, return_inverse=True)
    out = np.zeros((uniq.shape[0],) + upd.shape[1:], upd.dtype)
    np.add.at(out, inv, upd)
    return uniq.astype(idx.dtype), out
