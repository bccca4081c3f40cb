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
CUDA tensors launch the kernel or raise; either runs under `core.guard`
(`ring.guarded`: the depth ladder, the scan, the sentinel). `row_gather_at`
and `span_gather_at` launch the kernel at a given depth, unguarded. With ``depth=None`` the depth is
solved from the spec through `core.autotune.choose_depth` and recorded for
`autotune.last_choice`. The row gather reads its depth as tiles in flight
per SM and runs it as several blocks per SM (`ring.split_depth`; it
records blocks x slots); the span gather keeps one ring of `depth` tiles
per block. Indices outside the table are undefined behaviour,
as in the reference: checking them would cost a device-to-host sync.
`row_gather.launches` and `span_gather.launches` count kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.coro import CoroSpec, LoadStream
from repro_torch.kernels import ring

__all__ = [
    "row_gather",
    "row_gather_cost",
    "row_gather_at",
    "row_gather_plain",
    "row_gather_split",
    "row_gather_spec",
    "span_gather",
    "span_gather_at",
    "span_gather_cost",
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


def row_gather_cost(n: int, row_bytes: int) -> Tuple[int, int]:
    """(flops, bytes) of a gather of `n` rows of `row_bytes` bytes: each
    row read once and written once, and its int32 id read once; no
    arithmetic. The bound of `chip_smoke.py` and the dry-run's count."""
    return 0, 2 * n * row_bytes + 4 * n


def span_gather_cost(spans: int, span: int, row_bytes: int
                     ) -> Tuple[int, int]:
    """(flops, bytes) of a gather of `spans` spans of `span` rows: each
    row read once and written once, each span's int32 start read once."""
    return 0, 2 * spans * span * row_bytes + 4 * spans


def _meta_rows(kernel: str, table, ids, rows: int, cost) -> torch.Tensor:
    return ring.meta_call(kernel, cost, lambda: torch.empty(
        (rows, table.shape[1]), dtype=table.dtype, device="meta"),
        (table, ids))


def _check(table, idx, name: str) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be [R, d], got {tuple(table.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got {tuple(idx.shape)}")


def _check_ids(kernel: str, idx) -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"{kernel}: indices must be int32, got {idx.dtype}")


def _launch(kernel: str, table, idx, out, *, n_tiles: int,
            rows_per_tile: int, depth: int, unit: int, span: bool,
            blocks_per_sm: Optional[int] = None) -> None:
    _check_ids(kernel, idx)
    row_bytes = table.shape[1] * table.element_size()
    smem = depth * ring.ring_bytes(rows_per_tile * row_bytes, unit)
    ring.check_smem(smem, kernel=kernel, depth=depth,
                    tile=(rows_per_tile, table.shape[1]))
    grid, per_block = ring.launch_grid(table.device, n_tiles, depth, smem,
                                       THREADS, blocks_per_sm)
    lib = ring.library(SOURCE, "repro_gather", _ARGTYPES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.repro_gather(table.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), n_tiles, per_block, grid,
                               rows_per_tile, row_bytes, depth, int(span),
                               unit, stream)
    ring.raise_on_error(err, lib, kernel=kernel, depth=depth,
                        tile=(rows_per_tile, table.shape[1]))


def _slot_bytes(table, rows: int, unit: int) -> int:
    """Shared memory of one ring slot: a tile of `rows` rows of `table`."""
    return ring.ring_bytes(rows * table.shape[1] * table.element_size(), unit)


def _depth(spec, depth, table, rows: int, n_tiles: int):
    """(depth, copy unit) of a gather of `rows`-row tiles from `table`."""
    unit = ring.copy_unit(table.shape[1] * table.element_size(), (table,))
    return ring.solve_depth(spec, depth, n_tiles=n_tiles,
                            slot_bytes=_slot_bytes(table, rows, unit)), unit


def row_gather_split(depth: int, table: torch.Tensor,
                     rows_per_tile: int = 8):
    """(blocks per SM, slots a block) of a row gather from `table` whose
    clamped depth is `depth` tiles in flight per SM (`ring.split_depth`).
    `row_gather` runs and records this split: blocks x slots."""
    unit = ring.copy_unit(table.shape[1] * table.element_size(), (table,))
    return ring.split_depth(depth, threads=THREADS,
                            slot_bytes=_slot_bytes(table, rows_per_tile,
                                                   unit))


def row_gather(table: torch.Tensor, idx: torch.Tensor, *,
               depth: Optional[int] = None,
               rows_per_tile: int = 8) -> torch.Tensor:
    """out[i] = table[idx[i]]; len(idx) must divide into `rows_per_tile`.

    table: [R, d] of any type; idx: [n] int32, in range. `depth` is the
    number of tiles in flight per SM, run as `row_gather_split` blocks of
    slots; None solves it from `row_gather_spec` (and records blocks x
    slots).
    """
    n_tiles = _check_rows(table, idx, rows_per_tile)
    way = ring.route("row_gather", ("table", table), ("idx", idx))
    if way == "meta":
        n = idx.shape[0]
        return _meta_rows("row_gather", table, idx, n, row_gather_cost(
            n, table.shape[1] * table.element_size()))
    cuda = way == "cuda"
    solve = depth is None
    spec = row_gather_spec(rows_per_tile, table.shape[1], table.dtype)
    depth, _ = _depth(spec, depth, table, rows_per_tile, n_tiles)
    if cuda:
        _check_ids("row_gather", idx)

    def launch(d: int) -> torch.Tensor:
        blocks, slots = row_gather_split(d, table, rows_per_tile)
        return row_gather_at(table, idx, blocks_per_sm=blocks, slots=slots,
                             rows_per_tile=rows_per_tile)

    res = ring.guarded(spec, (table, idx), launch, row_gather_plain,
                       cuda=cuda, depth=depth)
    if solve or res.depth != depth:
        blocks, slots = row_gather_split(res.depth, table, rows_per_tile)
        autotune.record_choice("row_gather", blocks * slots)
    return res.out


def _check_rows(table, idx, rows_per_tile: int) -> int:
    """The tile count of a row gather; raises on what it does not take."""
    _check(table, idx, "idx")
    n = idx.shape[0]
    if rows_per_tile < 1 or n % rows_per_tile:
        raise ValueError(f"len(idx)={n} must divide into rows_per_tile="
                         f"{rows_per_tile}")
    return n // rows_per_tile


def row_gather_at(table: torch.Tensor, idx: torch.Tensor, *,
                  blocks_per_sm: int, slots: int,
                  rows_per_tile: int = 8) -> torch.Tensor:
    """`row_gather` on CUDA tensors at a given split: `blocks_per_sm`
    blocks on each SM, each keeping `slots` tiles in flight (no solve, no
    record). The kernel's launch count is `row_gather.launches`."""
    n_tiles = _check_rows(table, idx, rows_per_tile)
    if ring.route("row_gather", ("table", table), ("idx", idx)) != "cuda":
        raise ValueError("row_gather_at takes CUDA tensors")
    if blocks_per_sm < 1 or not 1 <= slots <= ring.MAX_DEPTH:
        raise ValueError(f"need blocks_per_sm >= 1 and 1 <= slots <= "
                         f"{ring.MAX_DEPTH}, got {blocks_per_sm}, {slots}")
    unit = ring.copy_unit(table.shape[1] * table.element_size(), (table,))
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if n_tiles:
        _launch("row_gather", table, idx, out, n_tiles=n_tiles,
                rows_per_tile=rows_per_tile, depth=slots, unit=unit,
                span=False, blocks_per_sm=blocks_per_sm)
        row_gather.launches += 1
    return out


def span_gather(table: torch.Tensor, starts: torch.Tensor, *, span: int = 8,
                depth: Optional[int] = None) -> torch.Tensor:
    """out[i*span:(i+1)*span] = table[starts[i]:starts[i]+span].

    starts: [T] int32 with starts[i] + span <= R. `depth` is the number of
    spans in flight per thread block; None solves it from `span_gather_spec`.
    """
    n_tiles = _check_span(table, starts, span)
    way = ring.route("span_gather", ("table", table), ("starts", starts))
    if way == "meta":
        return _meta_rows("span_gather", table, starts, n_tiles * span,
                          span_gather_cost(n_tiles, span, table.shape[1]
                                           * table.element_size()))
    cuda = way == "cuda"
    spec = span_gather_spec(span, table.shape[1], table.dtype)
    depth, _ = _depth(spec, depth, table, span, n_tiles)
    if cuda:
        _check_ids("span_gather", starts)
    res = ring.guarded(
        spec, (table, starts),
        lambda d: span_gather_at(table, starts, span=span, depth=d),
        lambda table, starts: span_gather_plain(table, starts, span),
        cuda=cuda, depth=depth)
    if res.depth != depth:
        autotune.record_choice("span_gather", res.depth)
    return res.out


def _check_span(table, starts, span: int) -> int:
    """The tile count of a span gather; raises on what it does not take."""
    _check(table, starts, "starts")
    if span < 1:
        raise ValueError(f"span must be >= 1, got {span}")
    return starts.shape[0]


def span_gather_at(table: torch.Tensor, starts: torch.Tensor, *, span: int,
                   depth: int) -> torch.Tensor:
    """`span_gather` on CUDA tensors with `depth` spans in flight per block
    (no solve, no record). The kernel's launch count is
    `span_gather.launches`."""
    n_tiles = _check_span(table, starts, span)
    if ring.route("span_gather", ("table", table),
                  ("starts", starts)) != "cuda":
        raise ValueError("span_gather_at takes CUDA tensors")
    if not 1 <= depth <= ring.MAX_DEPTH:
        raise ValueError(f"depth must be in [1, {ring.MAX_DEPTH}], got "
                         f"{depth}")
    unit = ring.copy_unit(table.shape[1] * table.element_size(), (table,))
    out = torch.empty((n_tiles * span, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if n_tiles:
        _launch("span_gather", table, starts, out, n_tiles=n_tiles,
                rows_per_tile=span, depth=depth, unit=unit, span=True)
        span_gather.launches += 1
    return out


row_gather.launches = 0
span_gather.launches = 0
