"""Context minimization (CoroAMU §III-B) as a compile-time classifier.

The paper classifies each loop variable by how it is updated across
suspension points:

  private    - updated from its own iteration only; must live in the
               per-coroutine context (here: per-slot VMEM scratch x depth)
  shared     - read-only, or commutative updates (order-independent
               accumulation); lives once, outside any slot
  sequential - order-dependent updates; serialized into the loop carry
               (executed at coroutine launch/retire, never concurrent)

On a GPU the "context" is the shared-memory working set of one thread
block's pipeline (VMEM on a TPU): private variables multiply by `depth`,
shared ones do not — so this classification bounds the reachable pipeline
depth.

`core.coro` consumes these specs declaratively: a kernel's `CoroSpec` lists
its context as `VarSpec`s. A `VarSpec` with ``shape=None`` is
accounting-only: it is counted against the budget (an operand block or a
loop-carry resident) but describes no buffer of its own.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Iterable, Optional, Tuple

import numpy as np

# Depth values returned by `max_depth` are clamped here so an "unbounded"
# answer (no per-slot bytes at all) can never flow into a scratch-shape
# allocation or an unrolled warmup loop. Mirrors `schedule.REQUEST_SLOTS` —
# the paper's "capped only by SPM request slots" bound.
MAX_DEPTH = 64


class VarClass(enum.Enum):
    PRIVATE = "private"
    SHARED = "shared"
    SEQUENTIAL = "sequential"


@dataclasses.dataclass(frozen=True)
class VarSpec:
    """A value live across a suspension point."""

    name: str
    nbytes: int
    read_only: bool = False
    # update depends on the variable's previous value?
    carries_dependence: bool = False
    # if it does: is the combining op commutative+associative (add/min/max)?
    commutative: bool = False
    # programmer hint overriding the analysis (paper: pragma shared_var)
    hint: Optional[VarClass] = None
    # Materialization for the declarative builder (core.coro): when `shape`
    # is given the builder allocates VMEM scratch for this variable; when
    # None the bytes are budget-accounting only.
    shape: Optional[Tuple[int, ...]] = None
    dtype: Any = None


def itemsize(dtype) -> int:
    """Bytes per element of a numpy dtype, a dtype name, or a `torch.dtype`
    (read through its ``itemsize`` attribute, so numpy need not know it)."""
    size = getattr(dtype, "itemsize", None)
    if isinstance(size, int):
        return size
    if str(dtype) == "bfloat16":
        return 2
    return int(np.dtype(dtype).itemsize)


def var(name: str, shape: Tuple[int, ...], dtype, **kwargs) -> VarSpec:
    """A materialized `VarSpec`: nbytes derived from `shape` x `dtype`."""
    shape = tuple(int(s) for s in shape)
    nbytes = int(math.prod(shape)) * itemsize(dtype)
    return VarSpec(name=name, nbytes=nbytes, shape=shape, dtype=dtype, **kwargs)


def classify(v: VarSpec) -> VarClass:
    """The paper's three-way classification (§III-B)."""
    if v.hint is not None:
        return v.hint
    if v.read_only:
        return VarClass.SHARED
    if not v.carries_dependence:
        return VarClass.PRIVATE
    if v.commutative:
        return VarClass.SHARED  # order-free reduction: share one accumulator
    return VarClass.SEQUENTIAL


def context_bytes(vs: Iterable[VarSpec], depth: int,
                  *, baseline: bool = False) -> int:
    """VMEM bytes of the pipeline context at a given depth.

    baseline=True models a conventional coroutine frame (everything private,
    as C++20 codegen would allocate) — the paper's Fig. 15 comparison point.
    """
    total = 0
    for v in vs:
        cls = VarClass.PRIVATE if baseline else classify(v)
        total += v.nbytes * (depth if cls is VarClass.PRIVATE else 1)
    return total


def max_depth(vs: Iterable[VarSpec], vmem_budget: int,
              *, baseline: bool = False, cap: int = MAX_DEPTH) -> int:
    """Largest pipeline depth whose context fits the VMEM budget.

    Clamped to `cap` (default `MAX_DEPTH`, the request-slot bound) so that a
    context with no per-slot bytes yields a finite, allocatable depth rather
    than a sentinel.
    """
    vs = list(vs)
    shared = sum(v.nbytes for v in vs
                 if not baseline and classify(v) is not VarClass.PRIVATE)
    per_slot = sum(v.nbytes for v in vs
                   if baseline or classify(v) is VarClass.PRIVATE)
    if per_slot == 0:
        return cap if shared <= vmem_budget else 0
    return min(max((vmem_budget - shared) // per_slot, 0), cap)
