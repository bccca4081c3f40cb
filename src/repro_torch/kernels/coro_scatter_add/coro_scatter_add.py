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
kernel and in the plain version alike. The wrapper reads its depth as
tiles in flight per SM and runs it as several blocks per SM
(`ring.split_depth`; it records blocks x slots); `scatter_add_at` launches
a given split. On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises. Either runs under `core.guard`
as a kernel that writes in place: a failure is retried at a smaller depth
only when the launch was refused before the kernel ran (a retry after the
launch would add the updates twice), and the scan and the sentinel read
the rows it wrote, the sentinel against those rows gathered before the
launch plus the updates (never a copy of the table). Indices outside the
table are undefined behaviour, as in the reference.
`scatter_add_unique.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import autotune
from repro_torch.core.coro import CoroSpec, LoadStream, StoreStream
from repro_torch.kernels import ring

__all__ = ["scatter_add_at", "scatter_add_cost", "scatter_add_spec", "scatter_add_split",
           "scatter_add_unique", "scatter_add_unique_plain",
           "updated_rows"]

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


def updated_rows(table: torch.Tensor, idx: torch.Tensor,
                 updates: torch.Tensor) -> torch.Tensor:
    """The rows a scatter-add writes, as the plain version computes them
    from `table` before it runs: table[idx] + updates, in f32, rounded once
    (the sentinel's reference)."""
    return (table.index_select(0, idx).float()
            + updates.float()).to(table.dtype)


def rows_finite(table: torch.Tensor, idx: torch.Tensor, *,
                bag: int = 1024) -> torch.Tensor:
    """Whether every value in the rows `idx` of `table` is finite, as a 0-d
    bool tensor on the table's device (the guard's scan of a scatter-add,
    which reads the rows it wrote without copying them out). The rows are
    summed in bags of `bag` (at most 2^11), each scaled by 2^-11 first, so
    that no sum of finite values can overflow, while a NaN or an Inf in any
    row leaves its bag's sum non-finite."""
    if not 1 <= bag <= 2048:
        raise ValueError(f"bag must be in [1, 2048], got {bag}")
    n = idx.shape[0]
    if n == 0:
        return torch.ones((), dtype=torch.bool, device=table.device)
    rows = idx.long()
    offsets = torch.arange(0, n, bag, device=table.device)
    scale = torch.full((n,), 2.0 ** -11, dtype=table.dtype,
                       device=table.device)
    sums = F.embedding_bag(rows, table, offsets, mode="sum",
                           per_sample_weights=scale)
    return torch.isfinite(sums).all()


def _slot_bytes(table: torch.Tensor, updates: torch.Tensor,
                rows_per_tile: int) -> int:
    """Shared memory of one ring slot: a tile of table rows and its update
    rows, in the copy unit the rows and both pointers allow."""
    row_bytes = table.shape[1] * table.element_size()
    unit = ring.copy_unit(row_bytes, (table, updates))
    return ring.ring_bytes(2 * rows_per_tile * row_bytes, unit)


def scatter_add_split(depth: int, table: torch.Tensor, updates: torch.Tensor,
                      rows_per_tile: int = 8):
    """(blocks per SM, slots a block) of a scatter-add into `table` whose
    clamped depth is `depth` tiles in flight per SM (`ring.split_depth`).
    `scatter_add_unique` runs and records this split: blocks x slots."""
    return ring.split_depth(depth, threads=THREADS,
                            slot_bytes=_slot_bytes(table, updates,
                                                   rows_per_tile))


def _check(table, idx, updates, rows_per_tile: int) -> int:
    """The tile count of a scatter-add; raises on what it does not take."""
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
    return n // rows_per_tile


def _check_types(table, idx, updates) -> None:
    """The types the kernel takes."""
    if table.dtype not in ring.DTYPE_CODE:
        raise TypeError(f"scatter_add: kernel takes float32 or bfloat16, got "
                        f"{table.dtype}")
    if updates.dtype != table.dtype or idx.dtype != torch.int32:
        raise TypeError(f"scatter_add: updates ({updates.dtype}) must match "
                        f"the table ({table.dtype}) and idx ({idx.dtype}) "
                        f"be int32")


def scatter_add_cost(n: int, d: int, itemsize: int) -> Tuple[int, int]:
    """(flops, bytes) of adding `n` update rows of `d` elements into
    distinct table rows: each table row read and written once, each update
    row and its int32 id read once; one add an element. The bound of
    `chip_smoke.py` and the dry-run's count."""
    return n * d, 3 * n * d * itemsize + 4 * n


def scatter_add_unique(table: torch.Tensor, idx: torch.Tensor,
                       updates: torch.Tensor, *, depth: Optional[int] = None,
                       rows_per_tile: int = 8) -> torch.Tensor:
    """In-place pipelined RMW: table[idx[i]] += updates[i]; returns `table`.

    table: [R, d] f32 or bf16; idx: [n] int32, duplicate-free and in range,
    n a multiple of `rows_per_tile`; updates: [n, d] in the table's type.
    `depth` is the number of tiles in flight per SM, run as
    `scatter_add_split` blocks of slots; None solves it from
    `scatter_add_spec` (and records blocks x slots).
    """
    n_tiles = _check(table, idx, updates, rows_per_tile)
    way = ring.route("scatter_add", ("table", table), ("idx", idx),
                     ("updates", updates))
    if way == "meta":          # in place: the table itself comes back
        return ring.meta_call("scatter_add", scatter_add_cost(
            idx.shape[0], table.shape[1], table.element_size()),
            lambda: table, (table, idx, updates))
    cuda = way == "cuda"
    solve = depth is None
    spec = scatter_add_spec(rows_per_tile, table.shape[1], table.dtype)
    depth = ring.solve_depth(
        spec, depth, n_tiles=n_tiles,
        slot_bytes=_slot_bytes(table, updates, rows_per_tile))
    if cuda:
        _check_types(table, idx, updates)

    def launch(d: int) -> torch.Tensor:
        blocks, slots = scatter_add_split(d, table, updates, rows_per_tile)
        return scatter_add_at(table, idx, updates, blocks_per_sm=blocks,
                              slots=slots, rows_per_tile=rows_per_tile)

    res = ring.guarded(spec, (table, idx, updates), launch,
                       scatter_add_unique_plain, cuda=cuda, depth=depth,
                       reference=updated_rows, in_place=True,
                       written=lambda t: t.index_select(0, idx),
                       finite=lambda t: rows_finite(t, idx))
    if solve or res.depth != depth:
        blocks, slots = scatter_add_split(res.depth, table, updates,
                                          rows_per_tile)
        autotune.record_choice("scatter_add", blocks * slots)
    return res.out


def scatter_add_at(table: torch.Tensor, idx: torch.Tensor,
                   updates: torch.Tensor, *, blocks_per_sm: int, slots: int,
                   rows_per_tile: int = 8) -> torch.Tensor:
    """`scatter_add_unique` on CUDA tensors at a given split: `blocks_per_sm`
    blocks on each SM, each keeping `slots` tiles in flight (no solve, no
    record). The kernel's launch count is `scatter_add_unique.launches`."""
    n_tiles = _check(table, idx, updates, rows_per_tile)
    if blocks_per_sm < 1 or not 1 <= slots <= ring.MAX_DEPTH:
        raise ValueError(f"need blocks_per_sm >= 1 and 1 <= slots <= "
                         f"{ring.MAX_DEPTH}, got {blocks_per_sm}, {slots}")
    if ring.route("scatter_add", ("table", table), ("idx", idx),
                  ("updates", updates)) != "cuda":
        raise ValueError("scatter_add_at takes CUDA tensors")
    _check_types(table, idx, updates)
    if n_tiles == 0:
        return table
    tile = (rows_per_tile, table.shape[1])
    row_bytes = table.shape[1] * table.element_size()
    unit = ring.copy_unit(row_bytes, (table, updates))
    smem = slots * _slot_bytes(table, updates, rows_per_tile)
    ring.check_smem(smem, kernel="scatter_add", depth=slots, tile=tile)
    grid, per_block = ring.launch_grid(table.device, n_tiles, slots, smem,
                                       THREADS, blocks_per_sm)
    lib = ring.library(SOURCE, "repro_scatter_add", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.repro_scatter_add(
            table.data_ptr(), idx.data_ptr(), updates.data_ptr(), n_tiles,
            per_block, grid, rows_per_tile, row_bytes, slots,
            ring.DTYPE_CODE[table.dtype], unit, stream)
    ring.raise_on_error(err, lib, kernel="scatter_add", depth=slots,
                        tile=tile)
    scatter_add_unique.launches += 1
    return table


scatter_add_unique.launches = 0
