"""STREAM triad declared as a `CoroSpec`, its CUDA wrapper and its plain
PyTorch version.

The bandwidth-bound end of the paper's benchmark suite (Table II): every
request is a maximal coarse-grained span (unit-stride loops coalesce
perfectly), so the pipeline measures pure issue/consume overlap — tiles of
b and c stream in while tiles of a stream back out. The CUDA kernel
(`csrc/triad.cu`, hand-written for sm_90a) replaces the TPU kernel
``src/repro/kernels/stream_copy/stream_copy.py:triad``.

The kernel cuts the arrays into items, equal slices of the caller's tile
of `rows` rows, and gives each thread block one item, loaded with one bulk
copy per array and stored with streaming stores: the block scheduler
starts the blocks in order, so the bytes in flight stay in one window that
moves through the arrays. The solved depth (tiles of `rows` rows in flight
per SM) sets the item: the largest slice such that the blocks resident on
an SM hold at most `depth` tiles (`plan`); the depth recorded is what the
resident blocks hold. Items off 16-byte sizes or addresses take the
kernel's unit path.

The scalar is rounded to the arrays' type first, as the reference passes
it; the product and the sum are each rounded in f32 and the result once to
the arrays' type, in the kernel and the plain version alike (the reference
rounds bf16 after each operation: within its 2e-2 bf16 tolerance). On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel or raises; either under `core.guard` (`ring.guarded`). `triad_at`
launches given items, unguarded. `triad.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.coro import CoroSpec, LoadStream, StoreStream
from repro_torch.kernels import ring

__all__ = ["Plan", "plan", "resident_blocks", "triad", "triad_at",
           "triad_cost",
           "triad_plain", "triad_spec"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "triad.cu"
THREADS = 128                  # kThreads in the .cu source
BARRIER_BYTES = 8              # the item's mbarrier
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


class Plan(NamedTuple):
    """How the kernel runs a triad: `items` items of `item_rows` rows (a
    divisor of the caller's `rows`), one a block; `blocks_per_sm` of them
    resident on an SM at once, holding `depth` tiles of `rows` rows
    (rounded up)."""
    item_rows: int
    items: int
    blocks_per_sm: int
    depth: int


def triad_spec(rows: int, d: int, dtype) -> CoroSpec:
    """STREAM tile: two span loads plus one span store per slot."""
    return CoroSpec(
        name="stream_triad",
        loads=(LoadStream("bs", (rows, d), dtype),
               LoadStream("cs", (rows, d), dtype)),
        stores=(StoreStream("as_", (rows, d), dtype),),
        flops_per_tile=float(2 * rows * d),  # fma per element
    )


def _scalar(scalar, dtype) -> float:
    """`scalar` rounded to `dtype` (a host tensor: no device sync)."""
    return float(torch.tensor(float(scalar), dtype=dtype))


def triad_plain(b: torch.Tensor, c: torch.Tensor, scalar) -> torch.Tensor:
    """a = b + scalar * c, each operation in f32, rounded once to b's type."""
    s = _scalar(scalar, b.dtype)
    return (b.float() + s * c.float()).to(b.dtype)


def resident_blocks(item_bytes: int) -> int:
    """Blocks of one item of `item_bytes` (of each array) that one SM holds
    at once (`ring.resident_blocks`; the unit path keeps no slot)."""
    smem = 2 * item_bytes + BARRIER_BYTES if item_bytes % 16 == 0 else 0
    return ring.resident_blocks(smem, THREADS)


def plan(n: int, d: int, itemsize: int, rows: int, depth: int) -> Plan:
    """The items of an [n, d] triad in tiles of `rows` rows at `depth`
    tiles in flight per SM (clamped by `ring.kernel_depth`: a tile's b and
    c in one block's shared memory, at most the tile count): the largest
    divisor of `rows` at most depth x rows over the blocks an SM's threads
    allow (whole 16-byte units when the tile is; else the smallest such
    divisor)."""
    row_bytes = d * itemsize
    depth = ring.kernel_depth(depth, slot_bytes=2 * rows * row_bytes,
                              n_tiles=n // rows)
    align = 16 if rows * row_bytes % 16 == 0 else 1
    fits = [r for r in range(rows, 0, -1)
            if rows % r == 0 and r * row_bytes % align == 0]
    most = depth * rows // (ring.MAX_THREADS_PER_SM // THREADS)
    r = next((r for r in fits if r <= most), fits[-1])
    per_sm = resident_blocks(r * row_bytes)
    return Plan(r, n // r, per_sm, -(-per_sm * r // rows))


def _check(b: torch.Tensor, c: torch.Tensor, rows: int) -> int:
    """The tile count of a triad; raises on what it does not take."""
    if b.dim() != 2 or c.shape != b.shape:
        raise ValueError(f"need b and c of one [N, d] shape, got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    if rows < 1 or b.shape[0] % rows:
        raise ValueError(f"N={b.shape[0]} must be a multiple of rows={rows}")
    return b.shape[0] // rows


def _check_types(b: torch.Tensor, c: torch.Tensor) -> None:
    """The types the kernel takes."""
    if b.dtype not in ring.DTYPE_CODE or c.dtype != b.dtype:
        raise TypeError(f"stream_triad: kernel takes float32 or bfloat16 "
                        f"arrays of one type, got {b.dtype} and {c.dtype}")


def triad_cost(n: int, itemsize: int) -> Tuple[int, int]:
    """(flops, bytes) of a triad over `n` elements a array: b and c read
    once, a written once; a multiply and an add an element. The bound of
    `chip_smoke.py` and the dry-run's count."""
    return 2 * n, 3 * n * itemsize


def triad(b: torch.Tensor, c: torch.Tensor, scalar, *, rows: int = 128,
          depth: Optional[int] = None) -> torch.Tensor:
    """a = b + scalar * c over [N, d] arrays, N a multiple of `rows`.

    `depth` is the number of tiles of `rows` rows in flight per SM, run as
    `plan`'s items; None solves it from `triad_spec` (and records the
    plan's depth).
    """
    n_tiles = _check(b, c, rows)
    way = ring.route("stream_triad", ("b", b), ("c", c))
    if way == "meta":
        return ring.meta_call("stream_triad", triad_cost(
            b.numel(), b.element_size()), lambda: torch.empty_like(b),
            (b, c))
    cuda = way == "cuda"
    n, d = b.shape
    spec = triad_spec(rows, d, b.dtype)
    solve = depth is None
    if solve:
        depth = autotune.choose_depth(spec.profile(), kernel=spec.name,
                                      vars=spec.all_vars())
    depth = ring.kernel_depth(depth, n_tiles=n_tiles,
                              slot_bytes=2 * rows * d * b.element_size())
    if cuda:
        _check_types(b, c)

    def launch(k: int) -> torch.Tensor:
        p = plan(n, d, b.element_size(), rows, k)
        return triad_at(b, c, scalar, rows=rows, item_rows=p.item_rows)

    res = ring.guarded(spec, (b, c), launch,
                       lambda b, c: triad_plain(b, c, scalar), cuda=cuda,
                       depth=depth)
    if solve or res.depth != depth:
        autotune.record_choice(spec.name, plan(n, d, b.element_size(), rows,
                                               res.depth).depth)
    return res.out


def triad_at(b: torch.Tensor, c: torch.Tensor, scalar, *, rows: int = 128,
             item_rows: int) -> torch.Tensor:
    """`triad` on CUDA tensors in items of `item_rows` rows (a divisor of
    `rows`), one a block; no solve, no record. Counts one launch."""
    n_tiles = _check(b, c, rows)
    if ring.route("stream_triad", ("b", b), ("c", c)) != "cuda":
        raise ValueError("triad_at takes CUDA tensors")
    _check_types(b, c)
    if item_rows < 1 or rows % item_rows:
        raise ValueError(f"need item_rows dividing rows={rows}, got "
                         f"{item_rows}")
    a = torch.empty_like(b)
    if n_tiles == 0:
        return a
    item_bytes = item_rows * b.shape[1] * b.element_size()
    unit = ring.copy_unit(item_bytes, (b, c, a))
    tile = (item_rows, b.shape[1])
    if unit == 16:
        ring.check_smem(2 * item_bytes + BARRIER_BYTES,
                        kernel="stream_triad", depth=1, tile=tile)
    lib = ring.library(SOURCE, "repro_triad", _ARGTYPES)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.repro_triad(b.data_ptr(), c.data_ptr(), a.data_ptr(),
                              _scalar(scalar, b.dtype),
                              b.shape[0] // item_rows, item_bytes,
                              ring.DTYPE_CODE[b.dtype], unit, stream)
    ring.raise_on_error(err, lib, kernel="stream_triad", depth=1, tile=tile)
    triad.launches += 1
    return a


triad.launches = 0
