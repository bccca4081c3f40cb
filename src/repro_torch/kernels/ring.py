"""Host side of the row-copy kernels' coroutine ring (``csrc/coro_ring.cuh``).

The gather, span-gather, scatter-add and triad kernels share one shape: a
thread block walks a contiguous range of tiles and keeps `depth` of them in
flight in a ring of shared-memory slots. This module solves and clamps the
depth, sizes the grid, picks the copy unit and raises on a failed launch.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.coro import CoroSpec
from repro_torch.core.guard import KernelCompileError, KernelResourceError

__all__ = ["MAX_DEPTH", "SMEM_LIMIT", "check_smem", "copy_unit",
           "kernel_depth", "launch_grid", "library", "raise_on_error",
           "ring_bytes", "route", "solve_depth"]

MAX_DEPTH = 64                 # kMaxDepth in csrc/coro_ring.cuh

SMEM_LIMIT = 232_448           # shared memory one block may use on sm_90
SM_SMEM = 233_472              # shared memory of one SM (228 KiB)
SMEM_RESERVED = 1_024          # the runtime's reservation per resident block
MAX_THREADS_PER_SM = 2_048
# cudaErrorMemoryAllocation, cudaErrorLaunchOutOfResources
_RESOURCE_ERRORS = (2, 701)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def kernel_depth(depth: int, *, slot_bytes: int, n_tiles: int) -> int:
    """Clamp a depth to what the kernel runs: at most `n_tiles` tiles, at
    most `MAX_DEPTH` (the deepest wait the kernels compile), and no more
    slots than one block's shared memory holds (`slot_bytes` each; at least
    one, which `check_smem` refuses on the card if it does not fit)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    fit = SMEM_LIMIT // max(slot_bytes, 1)
    return max(1, min(int(depth), MAX_DEPTH, fit, max(int(n_tiles), 1)))


def solve_depth(spec: CoroSpec, depth: Optional[int], *, slot_bytes: int,
                n_tiles: int) -> int:
    """The depth a call runs: `depth`, or the solve from `spec` when None
    (recorded for `autotune.last_choice`, after the clamp), clamped by
    `kernel_depth`. The same on CPU and CUDA tensors."""
    if depth is not None:
        return kernel_depth(depth, slot_bytes=slot_bytes, n_tiles=n_tiles)
    solved = autotune.choose_depth(spec.profile(), kernel=spec.name,
                                   vars=spec.all_vars())
    ran = kernel_depth(solved, slot_bytes=slot_bytes, n_tiles=n_tiles)
    autotune.record_choice(spec.name, ran)
    return ran


def check_smem(smem_bytes: int, *, kernel: str, depth: int,
               tile: Tuple[int, ...]) -> None:
    """Refuse a ring that does not fit one block's shared memory."""
    if smem_bytes > SMEM_LIMIT:
        raise KernelResourceError(
            f"a ring of {depth} slot(s) needs {smem_bytes} B of shared "
            f"memory, over {SMEM_LIMIT}", kernel=kernel, depth=depth,
            tile=tile)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_grid(device: torch.device, n_tiles: int, depth: int,
                smem_bytes: int, threads: int) -> Tuple[int, int]:
    """(blocks, tiles per block): as many blocks as fit on the card at once,
    but each walking at least `depth` tiles so that its ring fills."""
    per_sm = min(MAX_THREADS_PER_SM // threads,
                 SM_SMEM // (smem_bytes + SMEM_RESERVED))
    resident = _sm_count(device.index if device.index is not None
                         else torch.cuda.current_device()) * max(per_sm, 1)
    per_block = max(depth, -(-n_tiles // resident))
    return -(-n_tiles // per_block), per_block


def copy_unit(nbytes: int, tensors: Sequence[torch.Tensor]) -> int:
    """The widest copy unit, 16, 4, 2 or 1 bytes, that divides every row of
    `nbytes` and every base pointer of `tensors`."""
    for unit in (16, 4, 2):
        if nbytes % unit == 0 and all(t.data_ptr() % unit == 0
                                      for t in tensors):
            return unit
    return 1


def ring_bytes(nbytes: int, unit: int) -> int:
    """Shared memory that `nbytes` of data take in the ring: a 2- or 1-byte
    unit sits in a 4-byte slot (cp.async copies at least 4 bytes)."""
    return nbytes * max(1, 4 // unit)


def library(source: Path, fn_name: str, argtypes) -> ctypes.CDLL:
    """The built library of `source`, with `fn_name`'s signature declared."""
    from repro_torch.kernels import build

    lib = build.load(source)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(err: int, lib: ctypes.CDLL, *, kernel: str, depth: int,
                   tile: Tuple[int, ...]) -> None:
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        cls = KernelResourceError if err in _RESOURCE_ERRORS else \
            KernelCompileError
        raise cls(f"{kernel} launch failed: CUDA error {err} ({msg})",
                  kernel=kernel, depth=depth, tile=tile)


def route(kernel: str, *tensors: Tuple[str, torch.Tensor]) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raises on mixed devices, another device, and
    non-contiguous CUDA tensors."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"{tensors[0][0]} on {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return True
