"""Coroutine scatter-add: pipelined read-modify-write as a `CoroSpec`, its
CUDA wrapper and its plain PyTorch version.

GUPS's update side (and embedding-gradient / histogram scatter). Each tile:
  aload rows -> wait -> add updates -> astore rows

The CUDA kernel (`csrc/scatter_add.cu`, hand-written for sm_90a) replaces
the TPU kernel
``src/repro/kernels/coro_scatter_add/coro_scatter_add.py:scatter_add_unique``.
Like the aliased Pallas output, `scatter_add_unique` updates its `table`
argument in place (and returns it); `ops.coro_scatter_add` clones first, so
the caller sees the reference's functional result. Duplicate rows across
in-flight tiles would race: the ops layer combines them first
(`core.descriptors.dedup_rmw`, the compile-time stand-in for the paper's
await/asignal locks), so `idx` here must be duplicate-free.

The add is computed in f32 and rounded once to the table's type, in the
kernel and in the plain version alike. On CPU tensors the wrapper runs the
plain version; on CUDA tensors it launches the kernel or raises. Indices
outside the table are undefined behaviour, as in the reference.
`scatter_add_unique.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.coro import CoroSpec, LoadStream, StoreStream
from repro_torch.kernels import ring

__all__ = ["scatter_add_spec", "scatter_add_unique",
           "scatter_add_unique_plain"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "scatter_add.cu"
THREADS = 128                  # kThreads in the .cu source
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def scatter_add_spec(rows_per_tile: int, d: int, dtype) -> CoroSpec:
    """RMW tile: rows are loaded AND stored (2x traffic, 2x slot bytes)."""
    return CoroSpec(
        name="scatter_add",
        loads=(LoadStream("cur", (rows_per_tile, d), dtype,
                          group=rows_per_tile),),
        stores=(StoreStream("acc", (rows_per_tile, d), dtype,
                            group=rows_per_tile),),
        flops_per_tile=float(2 * rows_per_tile * d),
    )


def scatter_add_unique_plain(table: torch.Tensor, idx: torch.Tensor,
                             updates: torch.Tensor) -> torch.Tensor:
    """table[idx[i]] += updates[i] in place (idx duplicate-free), added in
    f32 and rounded once; returns `table`."""
    rows = idx.long()
    table[rows] = (table[rows].float() + updates.float()).to(table.dtype)
    return table


def scatter_add_unique(table: torch.Tensor, idx: torch.Tensor,
                       updates: torch.Tensor, *, depth: Optional[int] = None,
                       rows_per_tile: int = 8) -> torch.Tensor:
    """In-place pipelined RMW: table[idx[i]] += updates[i]; returns `table`.

    table: [R, d] f32 or bf16; idx: [n] int32, duplicate-free and in range,
    n a multiple of `rows_per_tile`; updates: [n, d] in the table's type.
    `depth` is the number of tiles in flight per thread block; None solves
    it from `scatter_add_spec`.
    """
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need table [R, d] and idx [n], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    n, d = idx.shape[0], table.shape[1]
    if tuple(updates.shape) != (n, d):
        raise ValueError(f"updates must be [{n}, {d}], got "
                         f"{tuple(updates.shape)}")
    if rows_per_tile < 1 or n % rows_per_tile:
        raise ValueError(f"len(idx)={n} must divide into rows_per_tile="
                         f"{rows_per_tile}")
    n_tiles = n // rows_per_tile
    cuda = ring.route("scatter_add", ("table", table), ("idx", idx),
                      ("updates", updates))
    spec = scatter_add_spec(rows_per_tile, d, table.dtype)
    row_bytes = d * table.element_size()
    unit = ring.copy_unit(row_bytes, (table, updates))
    slot_bytes = ring.ring_bytes(2 * rows_per_tile * row_bytes, unit)
    depth = ring.solve_depth(spec, depth, n_tiles=n_tiles,
                             slot_bytes=slot_bytes)
    if not cuda:
        return scatter_add_unique_plain(table, idx, updates)
    if table.dtype not in ring.DTYPE_CODE:
        raise TypeError(f"scatter_add: kernel takes float32 or bfloat16, got "
                        f"{table.dtype}")
    if updates.dtype != table.dtype or idx.dtype != torch.int32:
        raise TypeError(f"scatter_add: updates ({updates.dtype}) must match "
                        f"the table ({table.dtype}) and idx ({idx.dtype}) "
                        f"be int32")
    if n_tiles == 0:
        return table
    tile = (rows_per_tile, d)
    smem = depth * slot_bytes
    ring.check_smem(smem, kernel="scatter_add", depth=depth, tile=tile)
    grid, per_block = ring.launch_grid(table.device, n_tiles, depth, smem,
                                       THREADS)
    lib = ring.library(SOURCE, "repro_scatter_add", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.repro_scatter_add(
            table.data_ptr(), idx.data_ptr(), updates.data_ptr(), n_tiles,
            per_block, grid, rows_per_tile, row_bytes, depth,
            ring.DTYPE_CODE[table.dtype], unit, stream)
    ring.raise_on_error(err, lib, kernel="scatter_add", depth=depth,
                        tile=tile)
    scatter_add_unique.launches += 1
    return table


scatter_add_unique.launches = 0
