"""Coroutine gather: random-row gather declared as a `CoroSpec`, its CUDA
wrappers and their plain PyTorch versions.

The paper's flagship pattern (GUPS read side, hash-join probe, embedding
lookup). Two variants, both one CUDA kernel (`csrc/coro_gather.cu`,
hand-written for sm_90a) that keeps `depth` tiles in flight per thread
block:

  * `row_gather`  — one copy per requested row, `rows_per_tile` of them per
    tile (an aset group); replaces the TPU kernel
    ``src/repro/kernels/coro_gather/coro_gather.py:row_gather``.
  * `span_gather` — one copy of `span` contiguous rows per tile (the
    coarse-grained request of §III-C, fed by `core.descriptors.plan_gather`);
    replaces ``coro_gather.py:span_gather``.

Both are byte copies: f32, bf16 and int32 tables alike. Each wrapper picks
its path from the device of its tensors: CPU tensors run the plain version,
CUDA tensors launch the kernel or raise. With ``depth=None`` the depth is
solved from the spec through `core.autotune.choose_depth` and recorded for
`autotune.last_choice`. Indices outside the table are undefined behaviour,
as in the reference: checking them would cost a device-to-host sync.
`row_gather.launches` and `span_gather.launches` count kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.coro import CoroSpec, LoadStream
from repro_torch.kernels import ring

__all__ = [
    "row_gather",
    "row_gather_plain",
    "row_gather_spec",
    "span_gather",
    "span_gather_plain",
    "span_gather_spec",
    "span_rows",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "coro_gather.cu"
THREADS = 128                  # kThreads in the .cu source
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def row_gather_spec(rows_per_tile: int, d: int, dtype) -> CoroSpec:
    """One tile = `rows_per_tile` single-row copies (an aset group)."""
    return CoroSpec(
        name="row_gather",
        loads=(LoadStream("rows", (rows_per_tile, d), dtype,
                          group=rows_per_tile),),
        flops_per_tile=float(rows_per_tile * d),
    )


def span_gather_spec(span: int, d: int, dtype) -> CoroSpec:
    """One tile = one coarse-grained span copy (paper §III-C case 1)."""
    return CoroSpec(
        name="span_gather",
        loads=(LoadStream("span", (span, d), dtype),),
        flops_per_tile=float(span * d),
    )


# ----------------------------------------------------------- plain versions


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]."""
    return table[idx.long()]


def span_rows(starts: torch.Tensor, span: int) -> torch.Tensor:
    """The row ids a span gather reads: starts[i] + 0 .. span-1, flattened."""
    offs = torch.arange(span, device=starts.device, dtype=torch.long)
    return (starts.long()[:, None] + offs).reshape(-1)


def span_gather_plain(table: torch.Tensor, starts: torch.Tensor,
                      span: int) -> torch.Tensor:
    """out[i*span:(i+1)*span] = table[starts[i]:starts[i]+span]."""
    return table[span_rows(starts, span)]


# ------------------------------------------------------------ the kernels


def _check(table, idx, name: str) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be [R, d], got {tuple(table.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got {tuple(idx.shape)}")


def _launch(kernel: str, table, idx, out, *, n_tiles: int,
            rows_per_tile: int, depth: int, unit: int, span: bool) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"{kernel}: indices must be int32, got {idx.dtype}")
    row_bytes = table.shape[1] * table.element_size()
    smem = depth * ring.ring_bytes(rows_per_tile * row_bytes, unit)
    ring.check_smem(smem, kernel=kernel, depth=depth,
                    tile=(rows_per_tile, table.shape[1]))
    grid, per_block = ring.launch_grid(table.device, n_tiles, depth, smem,
                                       THREADS)
    lib = ring.library(SOURCE, "repro_gather", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.repro_gather(table.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), n_tiles, per_block, grid,
                               rows_per_tile, row_bytes, depth, int(span),
                               unit, stream)
    ring.raise_on_error(err, lib, kernel=kernel, depth=depth,
                        tile=(rows_per_tile, table.shape[1]))


def _depth(spec, depth, table, rows: int, n_tiles: int):
    """(depth, copy unit) of a gather of `rows`-row tiles from `table`."""
    row_bytes = table.shape[1] * table.element_size()
    unit = ring.copy_unit(row_bytes, (table,))
    return ring.solve_depth(spec, depth, n_tiles=n_tiles,
                            slot_bytes=ring.ring_bytes(rows * row_bytes,
                                                       unit)), unit


def row_gather(table: torch.Tensor, idx: torch.Tensor, *,
               depth: Optional[int] = None,
               rows_per_tile: int = 8) -> torch.Tensor:
    """out[i] = table[idx[i]]; len(idx) must divide into `rows_per_tile`.

    table: [R, d] of any type; idx: [n] int32, in range. `depth` is the
    number of tiles in flight per thread block; None solves it from
    `row_gather_spec`.
    """
    _check(table, idx, "idx")
    n = idx.shape[0]
    if rows_per_tile < 1 or n % rows_per_tile:
        raise ValueError(f"len(idx)={n} must divide into rows_per_tile="
                         f"{rows_per_tile}")
    n_tiles = n // rows_per_tile
    d = table.shape[1]
    cuda = ring.route("row_gather", ("table", table), ("idx", idx))
    depth, unit = _depth(row_gather_spec(rows_per_tile, d, table.dtype),
                         depth, table, rows_per_tile, n_tiles)
    if not cuda:
        return row_gather_plain(table, idx)
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    if n_tiles:
        _launch("row_gather", table, idx, out, n_tiles=n_tiles,
                rows_per_tile=rows_per_tile, depth=depth, unit=unit,
                span=False)
        row_gather.launches += 1
    return out


def span_gather(table: torch.Tensor, starts: torch.Tensor, *, span: int = 8,
                depth: Optional[int] = None) -> torch.Tensor:
    """out[i*span:(i+1)*span] = table[starts[i]:starts[i]+span].

    starts: [T] int32 with starts[i] + span <= R. `depth` is the number of
    spans in flight per thread block; None solves it from `span_gather_spec`.
    """
    _check(table, starts, "starts")
    if span < 1:
        raise ValueError(f"span must be >= 1, got {span}")
    n_tiles = starts.shape[0]
    d = table.shape[1]
    cuda = ring.route("span_gather", ("table", table), ("starts", starts))
    depth, unit = _depth(span_gather_spec(span, d, table.dtype), depth,
                         table, span, n_tiles)
    if not cuda:
        return span_gather_plain(table, starts, span)
    out = torch.empty((n_tiles * span, d), dtype=table.dtype,
                      device=table.device)
    if n_tiles:
        _launch("span_gather", table, starts, out, n_tiles=n_tiles,
                rows_per_tile=span, depth=depth, unit=unit, span=True)
        span_gather.launches += 1
    return out


row_gather.launches = 0
span_gather.launches = 0
