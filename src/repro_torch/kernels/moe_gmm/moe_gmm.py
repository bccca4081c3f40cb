"""Grouped matmul for the MoE experts: the kernel's `CoroSpec`, its CUDA
wrapper and its plain PyTorch version.

Each expert's weight matrix is the far-memory object: the kernel streams it
in k-slices through a ring of shared-memory slots while the tensor cores
consume the slice before (CoroAMU's hash-join build side). The CUDA kernel
(`csrc/moe_gmm.cu`, hand-written for sm_90a) replaces the TPU kernel
``src/repro/kernels/moe_gmm/moe_gmm.py:gmm`` and computes what it computes:
``out[e] = tokens[e] @ weights[e]`` with an f32 accumulator, cast to the
token type. It takes every shape, ragged on any axis, and a token block
whose expert stride is 0 (one block shared by every expert, as the dense
MoE layer passes it).

Depth: the reference's tile is a whole ``[dm, f_tile]`` column block of
one expert, and `gmm_spec` declares that tile, so the solve is the
reference's. The kernel's tile is a ``[BK, 128]`` k-slice (128 bytes of
each weight row: 64 rows in bf16, 32 in f32); it keeps the solved number of
k-slices in flight, clamped by `ring.kernel_depth` to what one block's
shared memory holds, to the number of k-slices and to `ring.MAX_DEPTH`.

`gmm` picks its path from the device of the tensors it is given: on CPU
tensors it runs `gmm_plain`; on CUDA tensors it launches the kernel or
raises. `gmm.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import autotune
from repro_torch.core import context as ctx_mod
from repro_torch.core.coro import CoroSpec, LoadStream
from repro_torch.kernels import ring

__all__ = ["F_TILE", "gmm", "gmm_plain", "gmm_spec", "kernel_depth",
           "n_slices", "slot_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
F_TILE = 128                   # kBN in the .cu source: columns per block
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


def gmm_spec(c: int, dm: int, f_tile: int, dtype,
             *, f_total: Optional[int] = None) -> CoroSpec:
    """Streamed expert-weight tile; the token block AND the expert's full
    [c, f] output block are depth-independent residents. The same
    declaration as the reference package's, so `choose_depth` gives the
    same depth in both under one `MachineModel`."""
    itemsize = ctx_mod.itemsize(dtype)
    return CoroSpec(
        name="moe_gmm",
        loads=(LoadStream("w", (dm, f_tile), dtype),),
        vars=(
            ctx_mod.VarSpec("tokens", nbytes=c * dm * itemsize,
                            read_only=True),
            ctx_mod.VarSpec("y_block", nbytes=c * (f_total or f_tile) * itemsize,
                            hint=ctx_mod.VarClass.SHARED),
        ),
        flops_per_tile=float(2 * c * dm * f_tile),
    )


# ------------------------------------------------------------ plain version


def gmm_plain(tokens: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """tokens [E, C, dm] @ weights [E, dm, f] -> [E, C, f]: an einsum in
    f32, cast to the token type."""
    return torch.einsum("ecd,edf->ecf", tokens.float(),
                        weights.float()).to(tokens.dtype)


# ------------------------------------------------------------- the kernel


def _token_tiles(c: int) -> int:
    """16-row token tiles per block (MT in the .cu source)."""
    return 1 if c <= 16 else 2


def _slice_rows(itemsize: int) -> int:
    """Rows of a k-slice: 128 bytes of every weight row (BK)."""
    return 128 // itemsize


def slot_bytes(c: int, itemsize: int) -> int:
    """Shared memory of one ring slot: the [BK, 128] weight slice and the
    [16 MT, BK] token slice, rows padded by 16 bytes (the .cu's Ring)."""
    bk, pad = _slice_rows(itemsize), 16 // itemsize
    return (bk * (F_TILE + pad) + 16 * _token_tiles(c) * (bk + pad)) * itemsize


def n_slices(dm: int, itemsize: int) -> int:
    """k-slices one block walks: its tiles."""
    return -(-dm // _slice_rows(itemsize))


def kernel_depth(depth: int, *, c: int, dm: int, itemsize: int) -> int:
    """Clamp a depth to the k-slices the kernel keeps in flight."""
    return ring.kernel_depth(depth, slot_bytes=slot_bytes(c, itemsize),
                             n_tiles=n_slices(dm, itemsize))


def _check(tokens: torch.Tensor, weights: torch.Tensor) -> None:
    if tokens.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"need tokens [E,C,dm] and weights [E,dm,f], got "
                         f"{tuple(tokens.shape)} and {tuple(weights.shape)}")
    if tokens.shape[0] != weights.shape[0] or \
            tokens.shape[2] != weights.shape[1]:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not fit weights "
                         f"{tuple(weights.shape)}")
    if tokens.device != weights.device:
        raise ValueError(f"weights are on {weights.device}, tokens on "
                         f"{tokens.device}")


def _check_cuda(tokens: torch.Tensor, weights: torch.Tensor,
                f_tile: int) -> None:
    if tokens.dtype not in ring.DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {tokens.dtype}")
    if weights.dtype != tokens.dtype:
        raise TypeError(f"weights ({weights.dtype}) must match tokens "
                        f"({tokens.dtype})")
    if f_tile != F_TILE:
        raise ValueError(f"the kernel's column tile is {F_TILE}, not {f_tile}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    if tokens.shape[2] > 1 and tokens.stride(2) != 1:
        raise ValueError("tokens need a unit column stride")


def _vectorized(tokens: torch.Tensor, weights: torch.Tensor) -> bool:
    """Every row, stride and base pointer a whole number of 16-byte units."""
    elems = math.gcd(tokens.shape[2], weights.shape[2], tokens.stride(0),
                     tokens.stride(1))
    return ring.copy_unit(elems * tokens.element_size(),
                          (tokens, weights)) == 16


def gmm(tokens: torch.Tensor, weights: torch.Tensor, *, f_tile: int = F_TILE,
        depth: Optional[int] = None) -> torch.Tensor:
    """tokens: [E, C, dm] (any expert and row stride, 0 included);
    weights: [E, dm, f] -> [E, C, f] in the token type.

    `depth` is the number of k-slices in flight; None solves it from
    `gmm_spec` through `core.autotune.choose_depth`. Either is clamped by
    `kernel_depth` and recorded as run, for
    `autotune.last_choice("moe_gmm")`.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise (`KernelCompileError` / `KernelResourceError` on a failed build or
    launch, ValueError / TypeError on inputs it does not take).
    """
    _check(tokens, weights)
    e, c, dm = tokens.shape
    f = weights.shape[2]
    itemsize = tokens.element_size()
    spec = gmm_spec(c, dm, f_tile, weights.dtype, f_total=f)
    depth = ring.solve_depth(spec, depth, slot_bytes=slot_bytes(c, itemsize),
                             n_tiles=n_slices(dm, itemsize))
    autotune.record_choice(spec.name, depth)
    if tokens.device.type == "cpu":
        return gmm_plain(tokens, weights)
    if tokens.device.type != "cuda":
        raise ValueError(f"moe_gmm: no kernel for device {tokens.device}")
    _check_cuda(tokens, weights, f_tile)
    out = torch.empty((e, c, f), dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    tile = (_slice_rows(itemsize), F_TILE)
    ring.check_smem(depth * slot_bytes(c, itemsize), kernel="moe_gmm",
                    depth=depth, tile=tile)
    lib = ring.library(SOURCE, "repro_moe_gmm", _ARGTYPES)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        err = lib.repro_moe_gmm(
            tokens.data_ptr(), weights.data_ptr(), out.data_ptr(), e, c, dm,
            f, tokens.stride(0), tokens.stride(1), depth,
            ring.DTYPE_CODE[tokens.dtype], _token_tiles(c),
            int(_vectorized(tokens, weights)), stream)
    ring.raise_on_error(err, lib, kernel="moe_gmm", depth=depth, tile=tile)
    gmm.launches += 1
    return out


gmm.launches = 0
