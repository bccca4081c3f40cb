"""Host side of the row-copy kernels' coroutine ring (``csrc/coro_ring.cuh``).

The gather, span-gather and scatter-add kernels share one shape: a thread
block walks a contiguous range of tiles and keeps `depth` of them in flight
in a ring of shared-memory slots. This module solves and clamps the depth,
splits the row gather's and the scatter-add's depth over the blocks of an
SM, counts the blocks an SM holds, sizes the grid, picks the copy unit,
raises on a failed launch and runs a wrapper's call under `core.guard`
(the triad and the other kernels use these too).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core import autotune, guard
from repro_torch.core.coro import CoroSpec
from repro_torch.core.guard import KernelCompileError, KernelResourceError

__all__ = ["MAX_DEPTH", "NoBackwardError", "SMEM_LIMIT", "check_smem",
           "copy_unit", "guarded", "kernel_depth", "launch_grid", "library",
           "meta_call", "raise_on_error", "resident_blocks", "ring_bytes",
           "route",
           "sm_count", "solve_depth", "split_depth"]

MAX_DEPTH = 64                 # kMaxDepth in csrc/coro_ring.cuh

SMEM_LIMIT = 232_448           # shared memory one block may use on sm_90
SM_SMEM = 233_472              # shared memory of one SM (228 KiB)
SMEM_RESERVED = 1_024          # the runtime's reservation per resident block
MAX_THREADS_PER_SM = 2_048
# cudaErrorMemoryAllocation, cudaErrorLaunchOutOfResources: the launch was
# refused before the kernel ran, so a smaller depth may fit
_RESOURCE_ERRORS = (2, 701)
# sticky errors: the CUDA context is lost and no later launch can succeed
# (illegal address, launch timeout, device assert, hardware stack error,
# illegal instruction, misaligned address, invalid address space, invalid
# PC, launch failure)
_STICKY_ERRORS = (700, 702, 710, 714, 715, 716, 717, 718, 719)
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


def split_depth(depth: int, *, slot_bytes: int,
                threads: int) -> Tuple[int, int]:
    """(blocks per SM, slots a block) that keep `depth` tiles in flight on
    one SM: `depth` (already clamped by `kernel_depth`) is read as tiles
    in flight per SM and split over the most blocks that threads and the
    SM's shared memory allow, counting the runtime's reservation per
    block, each holding ceil(depth / blocks) slots and at least 2 (one
    block of `depth` slots when depth < 4). One block always fits, since
    `kernel_depth` caps a ring at `SMEM_LIMIT`. The depth that runs is
    blocks x slots."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    most = min(MAX_THREADS_PER_SM // threads, max(1, depth // 2))
    for blocks in range(most, 0, -1):
        slots = -(-depth // blocks)
        if blocks * (slots * slot_bytes + SMEM_RESERVED) <= SM_SMEM:
            return blocks, slots
    return 1, depth


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
            tile=tile, refused=True)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of `device`'s card, read once per device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def launch_grid(device: torch.device, n_tiles: int, depth: int,
                smem_bytes: int, threads: int,
                blocks_per_sm: Optional[int] = None) -> Tuple[int, int]:
    """(blocks, tiles per block): as many blocks as fit on the card at once
    (`blocks_per_sm` on each SM when given), but each walking at least
    `depth` tiles so that its ring fills."""
    per_sm = blocks_per_sm or resident_blocks(smem_bytes, threads)
    resident = sm_count(device) * max(per_sm, 1)
    per_block = max(depth, -(-n_tiles // resident))
    return -(-n_tiles // per_block), per_block


def resident_blocks(smem_bytes: int, threads: int) -> int:
    """Blocks of `threads` threads and `smem_bytes` of shared memory that
    one SM holds at once, counting the runtime's reservation per block."""
    return min(MAX_THREADS_PER_SM // threads,
               SM_SMEM // (smem_bytes + SMEM_RESERVED))


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
    """Raise the typed error of a nonzero CUDA status: `KernelResourceError`
    marked refused for codes 2 and 701, `KernelCompileError` otherwise,
    marked not retriable for a sticky code (`core.guard`'s ladder reads
    both marks)."""
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        text = f"{kernel} launch failed: CUDA error {err} ({msg})"
        if err in _RESOURCE_ERRORS:
            raise KernelResourceError(text, kernel=kernel, depth=depth,
                                      tile=tile, refused=True)
        raise KernelCompileError(text, kernel=kernel, depth=depth, tile=tile,
                                 retriable=err not in _STICKY_ERRORS)


def route(kernel: str, *tensors: Tuple[str, torch.Tensor],
          contiguous: bool = True) -> str:
    """Where a call runs, from its tensors' device: ``"cuda"`` (launch the
    kernel), ``"cpu"`` (run the plain version) or ``"meta"`` (the
    dry-run's trace: no plain version, no launch, no guard; the wrapper
    returns an empty meta output through `meta_call`). Raises on mixed
    devices (meta beside another device too), on another device, and on
    non-contiguous CUDA tensors when `contiguous`."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"{tensors[0][0]} on {dev}")
    if dev.type in ("cpu", "meta"):
        return dev.type
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    if contiguous:
        for name, t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{kernel}: {name} must be contiguous")
    return "cuda"


def meta_call(kernel: str, cost: Tuple[float, float], make: Callable,
              operands: Sequence = ()):
    """The meta route of a wrapper: `make()`'s empty meta output, the
    kernel's (flops, bytes) `cost` on its `operands` recorded in the open
    `roofline.StepCounter` (if any) as one call of `kernel`. Nothing is
    launched, run or checked: meta tensors hold no data."""
    from repro_torch import roofline

    with roofline.kernel_call(kernel, *cost, operands=operands):
        return make()


class NoBackwardError(TypeError):
    """A kernel with no backward was called on CUDA tensors of which one
    requires grad: its output, a fresh tensor from a ctypes launch, would
    cut the autograd graph without a word. `kernel` names it."""

    def __init__(self, kernel: str):
        super().__init__(
            f"{kernel}: the CUDA kernel has no backward, and an operand "
            f"requires grad; call it under torch.no_grad() or on detached "
            f"tensors (the plain version runs only on CPU tensors)")
        self.kernel = kernel


def _refuse_grad(kernel: str, operands: Sequence) -> None:
    """Raise `NoBackwardError` when grad mode is on and an operand
    requires grad. A differentiable wrapper (`moe_gmm`) calls the kernel
    inside its `autograd.Function`, where grad mode is off."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in operands):
        raise NoBackwardError(kernel)


def guarded(spec: CoroSpec, operands: Sequence, launch: Callable[[int], object],
            plain: Callable, *, cuda: bool, depth: int, n_tiles: int = 0,
            reference: Optional[Callable] = None, in_place: bool = False,
            written: Optional[Callable] = None,
            finite: Optional[Callable] = None) -> guard.GuardResult:
    """A kernel wrapper's call under `core.guard.guarded_call`: each attempt
    at depth d runs `launch(d)` on CUDA tensors (`cuda`) and
    `plain(*operands)` on CPU tensors. The sentinel compares `written(out)`
    with `reference(*operands)` (default `plain`), computed before the
    attempt; the scan reads `written(out)`, or calls `finite(out)`;
    `in_place` marks a kernel that updates an operand. On CUDA tensors an
    operand that requires grad (under grad mode) raises `NoBackwardError`;
    on CPU tensors the plain version runs with autograd live."""
    if cuda:
        _refuse_grad(spec.name, operands)

    def attempt(d: int):
        return launch(d) if cuda else plain(*operands)

    return guard.guarded_call(spec, operands, attempt, depth=depth,
                              n_tiles=n_tiles, plain=reference or plain,
                              in_place=in_place, written=written,
                              finite=finite)
