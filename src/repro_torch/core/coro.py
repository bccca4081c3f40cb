"""Coroutine kernel declarations: what a pipelined kernel streams and keeps.

A kernel declares a `CoroSpec` — its decoupled input/output streams
(`LoadStream` / `StoreStream`, one tile each per in-flight slot) and its
context (`core.context.VarSpec`s). From the declaration the host derives,
per pipeline depth, the tile's `TileProfile` for the depth solver and the
classified context bytes that cap the depth (private x depth,
shared/sequential x 1, paper §III-B).

Correspondence with the paper's model:

  aload    -> LoadStream    (decoupled global -> shared-memory copy group)
  astore   -> StoreStream   (decoupled write-back)
  context  -> CoroSpec.vars (classified by core.context.classify)

There is no builder here: each CUDA kernel owns its tile loop and its ring
of `depth` page buffers, and reads the depth the host solved from the
spec (`core.autotune.choose_depth(spec.profile(), vars=spec.all_vars())`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

from repro_torch.core import context as ctx_mod

__all__ = ["CoroSpec", "LoadStream", "StoreStream"]


def _check_group(stream) -> None:
    if stream.group < 1 or stream.tile[0] % stream.group:
        raise ValueError(
            f"stream {stream.name!r}: tile[0]={stream.tile[0]} must divide "
            f"into group={stream.group} equal chunks")


@dataclasses.dataclass(frozen=True)
class LoadStream:
    """A decoupled input stream (aload/aset): one slot buffer per in-flight
    tile. `src` optionally names where tile `i` comes from; the CUDA kernels
    compute their own addresses, so the port's specs leave it None."""

    name: str
    tile: Tuple[int, ...]
    dtype: Any
    src: Optional[Callable[..., Any]] = None
    group: int = 1

    def __post_init__(self):
        _check_group(self)

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.tile)) * ctx_mod.itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class StoreStream:
    """A decoupled output stream (astore) with read-modify-write drain."""

    name: str
    tile: Tuple[int, ...]
    dtype: Any
    dst: Optional[Callable[..., Any]] = None
    group: int = 1

    def __post_init__(self):
        _check_group(self)

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.tile)) * ctx_mod.itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class CoroSpec:
    """Declarative description of one coroutine kernel family."""

    name: str
    loads: Tuple[LoadStream, ...] = ()
    stores: Tuple[StoreStream, ...] = ()
    vars: Tuple[ctx_mod.VarSpec, ...] = ()
    flops_per_tile: float = 0.0

    def __post_init__(self):
        names = [s.name for s in self.loads] + [s.name for s in self.stores] \
            + [v.name for v in self.vars]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stream/var names in spec: {names}")

    # ---- derived context (paper §III-B)

    def stream_vars(self) -> Tuple[ctx_mod.VarSpec, ...]:
        """Every stream slot is private context: one copy per in-flight tile."""
        return tuple(
            ctx_mod.VarSpec(name=s.name, nbytes=s.nbytes,
                            shape=tuple(s.tile), dtype=s.dtype)
            for s in (*self.loads, *self.stores)
        )

    def all_vars(self) -> Tuple[ctx_mod.VarSpec, ...]:
        return (*self.stream_vars(), *self.vars)

    def context_bytes(self, depth: int, *, baseline: bool = False) -> int:
        """Classified working set at `depth` (Fig. 15's comparison)."""
        return ctx_mod.context_bytes(self.all_vars(), depth, baseline=baseline)

    def tile_bytes(self) -> int:
        """Global-memory traffic per tile: every stream moves its tile."""
        return sum(s.nbytes for s in (*self.loads, *self.stores))

    def profile(self):
        from repro_torch.core.schedule import TileProfile

        return TileProfile(tile_bytes=self.tile_bytes(),
                           flops_per_tile=float(self.flops_per_tile))

    def materialized_vars(self) -> Tuple[ctx_mod.VarSpec, ...]:
        return tuple(v for v in self.vars if v.shape is not None)
