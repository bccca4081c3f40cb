"""STREAM triad declared as a `CoroSpec`, its CUDA wrapper and its plain
PyTorch version.

The bandwidth-bound end of the paper's benchmark suite (Table II): every
request is a maximal coarse-grained span (unit-stride loops coalesce
perfectly), so the pipeline measures pure issue/consume overlap — tiles of
b and c stream in while tiles of a stream back out. The CUDA kernel
(`csrc/triad.cu`, hand-written for sm_90a) replaces the TPU kernel
``src/repro/kernels/stream_copy/stream_copy.py:triad``.

The scalar is rounded to the arrays' type first, as the reference passes
it; the product and the sum are each rounded in f32 and the result once to
the arrays' type, in the kernel and the plain version alike (the reference
rounds bf16 after each operation: within its 2e-2 bf16 tolerance). On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel or raises. `triad.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.coro import CoroSpec, LoadStream, StoreStream
from repro_torch.kernels import ring

__all__ = ["triad", "triad_plain", "triad_spec"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "triad.cu"
THREADS = 256                  # kThreads in the .cu source
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


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


def triad(b: torch.Tensor, c: torch.Tensor, scalar, *, rows: int = 128,
          depth: Optional[int] = None) -> torch.Tensor:
    """a = b + scalar * c over [N, d] arrays, N a multiple of `rows`.

    `depth` is the number of tiles of `rows` rows in flight per thread
    block; None solves it from `triad_spec`.
    """
    if b.dim() != 2 or c.shape != b.shape:
        raise ValueError(f"need b and c of one [N, d] shape, got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    n, d = b.shape
    if rows < 1 or n % rows:
        raise ValueError(f"N={n} must be a multiple of rows={rows}")
    n_tiles = n // rows
    cuda = ring.route("stream_triad", ("b", b), ("c", c))
    spec = triad_spec(rows, d, b.dtype)
    tile_bytes = rows * d * b.element_size()
    unit = ring.copy_unit(tile_bytes, (b, c))
    slot_bytes = ring.ring_bytes(2 * tile_bytes, unit)
    depth = ring.solve_depth(spec, depth, n_tiles=n_tiles,
                             slot_bytes=slot_bytes)
    if not cuda:
        return triad_plain(b, c, scalar)
    if b.dtype not in ring.DTYPE_CODE or c.dtype != b.dtype:
        raise TypeError(f"stream_triad: kernel takes float32 or bfloat16 "
                        f"arrays of one type, got {b.dtype} and {c.dtype}")
    a = torch.empty_like(b)
    if n_tiles == 0:
        return a
    tile = (rows, d)
    smem = depth * slot_bytes
    ring.check_smem(smem, kernel="stream_triad", depth=depth, tile=tile)
    grid, per_block = ring.launch_grid(b.device, n_tiles, depth, smem,
                                       THREADS)
    lib = ring.library(SOURCE, "repro_triad", _ARGTYPES)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.repro_triad(b.data_ptr(), c.data_ptr(), a.data_ptr(),
                              _scalar(scalar, b.dtype), n_tiles, per_block,
                              grid, tile_bytes, depth,
                              ring.DTYPE_CODE[b.dtype], unit, stream)
    ring.raise_on_error(err, lib, kernel="stream_triad", depth=depth,
                        tile=tile)
    triad.launches += 1
    return a


triad.launches = 0
