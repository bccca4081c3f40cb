"""Chunked Mamba-2 SSD scan: the kernel's `CoroSpec`, its CUDA wrapper and
its plain PyTorch version.

For each sequence, from a zero state, the scan streams the sequence's
chunks (x, dt, B, C) through a small recurrent state ``[nh, p, n]`` — the
paper's coroutine pipeline with a *sequential* context variable. The CUDA
kernel (`csrc/ssd_scan.cu`, hand-written for sm_90a) replaces the TPU
kernel ``src/repro/kernels/ssd_scan/ssd_scan.py:ssd_scan`` and computes
what it computes: ``y`` in x's type and the final state ``h_final
[b, nh, p, n]`` in f32. It takes each operand's own type (x, B and C in
one type, dt in another: the SSM block passes dt in f32 after the
softplus), and x, B and C as strided views (slices of the block's joint
projection) whose rows are whole 16-byte units.

The kernel (three launches, one call) runs Mamba-2's chunked
decomposition in parallel over chunks of `CHUNK` rows (128 in bf16, 64 in
f32, whatever the caller's chunk: equal but for rounding): each chunk's
own state into an f32 workspace (`workspace_bytes`), a pass along the
chunks that turns them into the state entering each chunk, and each
chunk's output through C B^T, computed once for a group of `HEAD_GROUP`
heads. `plan` says what a call runs.

Depth: `ssd_spec` declares the reference's chunk tile, so the solve is the
reference's (its per-sequence ``y_block`` resident alone is over a block's
shared memory at a real sequence length, so it falls to the floor). The
kernel reads it as the heads' tiles a block keeps in flight, clamped by
`kernel_depth` to what one block's shared memory holds, to the heads of a
group and to `ring.MAX_DEPTH`.

`ssd_scan` picks its path from the device of the tensors it is given: on
CPU tensors it runs `ssd_scan_plain`; on CUDA tensors it launches the
kernel or raises. `ssd_scan.launches` counts kernel launches (and nothing
else).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.core import autotune
from repro_torch.core import context as ctx_mod
from repro_torch.core.coro import CoroSpec, LoadStream
from repro_torch.core.guard import KernelResourceError
from repro_torch.kernels import ring

__all__ = ["CHUNK", "HEAD_GROUP", "LAUNCHES", "MAX_HEAD", "MAX_STATE",
           "Plan", "fixed_bytes", "kernel_depth", "plan", "slot_bytes",
           "ssd_scan", "ssd_scan_at", "ssd_scan_plain", "ssd_spec",
           "workspace_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
CHUNK = {torch.bfloat16: 128, torch.float32: 64}   # kL in the .cu source
MAX_STATE = 128                # the largest state width n the kernel takes
MAX_HEAD = 128                 # the largest head width p the kernel takes
HEAD_GROUP = 12                # heads that share a block (and its C B^T)
LAUNCHES = 3                   # kernels a call launches
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])


class Plan(NamedTuple):
    """What one kernel call runs: `chunks` chunks of `chunk` rows a
    sequence, `groups` groups of `group` heads (the last may hold fewer),
    `depth` heads' tiles in flight a block, an f32 workspace of
    `workspace_bytes`, `launches` kernels."""
    chunk: int
    chunks: int
    group: int
    groups: int
    depth: int
    workspace_bytes: int
    launches: int


def ssd_spec(chunk: int, nh: int, p: int, n: int, dtype,
             *, seq_len: Optional[int] = None) -> CoroSpec:
    """Chunk tile: x/dt/B/C stream per slot; the recurrent state is
    sequential (one copy) and the per-batch y/h-out blocks are residents.
    The same declaration as the reference package's, so `choose_depth`
    gives the same depth in both under one `MachineModel`."""
    itemsize = ctx_mod.itemsize(dtype)
    return CoroSpec(
        name="ssd_scan",
        loads=(
            LoadStream("x", (chunk, nh, p), dtype),
            LoadStream("dt", (chunk, nh), dtype),
            LoadStream("bmat", (chunk, n), dtype),
            LoadStream("cmat", (chunk, n), dtype),
        ),
        vars=(
            # recurrent state: order-dependent update -> SEQUENTIAL, one copy
            ctx_mod.var("h", (nh, p, n), "float32", carries_dependence=True),
            # per-batch residents: h-out f32 block + y output block
            ctx_mod.VarSpec("h_out_block", nbytes=4 * nh * p * n,
                            hint=ctx_mod.VarClass.SHARED),
            ctx_mod.VarSpec("y_block",
                            nbytes=(seq_len or chunk) * nh * p * itemsize,
                            hint=ctx_mod.VarClass.SHARED),
        ),
        flops_per_tile=float(2 * chunk * chunk * (n + nh * p)),
    )


# ------------------------------------------------------------ plain version


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int):
    """The kernel's function in plain PyTorch: the chunked SSD of
    `models.ssm.chunked_ssd` at `chunk`, from a zero state, in f32.
    Returns (y [b,s,nh,p] in x's type, h_final [b,nh,p,n] f32)."""
    # imported here: models.ssm calls this module's wrapper
    from repro_torch.models.ssm import chunked_ssd

    return chunked_ssd(x, dt, A, B, C, chunk)


# ------------------------------------------------------------- the kernel


def _layout(p: int, n: int, itemsize: int) -> dict:
    """Byte sizes of the kernel's shared-memory tiles (the .cu's `Smem`):
    bf16 pads p and n to 16, each bf16 row by 8 values and each state row
    by 12; f32 pads nothing but C B^T's rows, by 4 values."""
    L = CHUNK[torch.bfloat16 if itemsize == 2 else torch.float32]
    tc = itemsize == 2
    pp, np_ = (-(-p // 16) * 16, -(-n // 16) * 16) if tc else (p, n)
    xs, bs, hs = (pp + 8, np_ + 8, np_ + 12) if tc else (p, n, n)
    return dict(tc=tc, x=L * xs * itemsize, bc=L * bs * itemsize,
                h=pp * hs * 4, cb=L * (L + (8 if tc else 4)) * 4, dtw=L * 4,
                vec=(3 * L + 8) * 4)


def slot_bytes(p: int, n: int, itemsize: int) -> int:
    """Shared memory of one ring slot of the scan kernel (the .cu's
    slot_c): a head's x tile, its entering f32 state and its dt words."""
    m = _layout(p, n, itemsize)
    return m["x"] + m["h"] + m["dtw"]


def fixed_bytes(p: int, n: int, itemsize: int) -> int:
    """Shared memory of the scan kernel beside the ring (the .cu's
    fixed_c): C, C B^T, a head's decayed scores (the size of C B^T), the
    vectors, and in f32 B."""
    m = _layout(p, n, itemsize)
    return (1 if m["tc"] else 2) * m["bc"] + 2 * m["cb"] + m["vec"]


def kernel_depth(depth: int, *, p: int, n: int, itemsize: int,
                 n_tiles: int) -> int:
    """Clamp a depth to the heads' tiles a block keeps in flight: at most
    `n_tiles` (the heads of a group), at most `ring.MAX_DEPTH`, and no more
    slots than one block's shared memory holds beside C, C B^T and the
    decayed scores."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    fixed, slot = fixed_bytes(p, n, itemsize), slot_bytes(p, n, itemsize)
    fit = (ring.SMEM_LIMIT - fixed) // slot
    if fit < 1:
        raise KernelResourceError(
            f"one tile slot and the chunk's tiles need {fixed + slot} B of "
            f"shared memory, over {ring.SMEM_LIMIT}", kernel="ssd_scan",
            depth=1, tile=(p, n), refused=True)
    return max(1, min(int(depth), ring.MAX_DEPTH, fit, max(int(n_tiles), 1)))


def workspace_bytes(b: int, s: int, nh: int, p: int, n: int,
                    itemsize: int) -> int:
    """The f32 workspace of a call: every chunk's state [b, chunks, nh, p,
    n] and its sum of dt A [b, chunks, nh]."""
    L = CHUNK[torch.bfloat16 if itemsize == 2 else torch.float32]
    chunks = -(-s // L)
    return 4 * b * chunks * nh * (p * n + 1)


def plan(b: int, s: int, nh: int, p: int, n: int, itemsize: int,
         depth: int, group: int = HEAD_GROUP) -> Plan:
    """The kernel's plan for a call at `depth` (clamped by `kernel_depth`
    to the group's heads) and head group `group` (at most nh)."""
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    group = min(group, nh)
    L = CHUNK[torch.bfloat16 if itemsize == 2 else torch.float32]
    return Plan(L, -(-s // L), group, -(-nh // group),
                kernel_depth(depth, p=p, n=n, itemsize=itemsize,
                             n_tiles=group),
                workspace_bytes(b, s, nh, p, n, itemsize), LAUNCHES)


def _check(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3:
        raise ValueError(f"need x [b,s,nh,p], dt [b,s,nh], A [nh], B and C "
                         f"[b,s,n], got {tuple(x.shape)}, {tuple(dt.shape)},"
                         f" {tuple(A.shape)}, {tuple(B.shape)}")
    b, s, nh, _ = x.shape
    if tuple(dt.shape) != (b, s, nh) or tuple(A.shape) != (nh,) or \
            B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")


def _check_cuda(x, dt, B, C) -> None:
    if x.dtype not in ring.DTYPE_CODE or dt.dtype not in ring.DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got x {x.dtype}"
                        f" and dt {dt.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B ({B.dtype}) and C ({C.dtype}) must match x "
                        f"({x.dtype})")
    p, n = x.shape[3], B.shape[2]
    if n > MAX_STATE or p > MAX_HEAD:
        raise ValueError(f"state width {n} or head width {p} over "
                         f"{MAX_STATE} or {MAX_HEAD}")
    if x.stride(3) != 1 or (x.shape[2] > 1 and x.stride(2) != p) or \
            B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("x needs packed heads of unit stride, B and C a "
                         "unit stride along the state")
    itemsize = x.element_size()
    strides = [x.stride(d) for d in (0, 1) if x.shape[d] > 1]
    strides += [t.stride(d) for t in (B, C) for d in (0, 1) if t.shape[d] > 1]
    if any((v * itemsize) % 16 for v in [p, n] + strides) or \
            any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("rows of x, B and C must be whole 16-byte units at "
                         "16-byte aligned addresses (cp.async)")
    if dt.data_ptr() % dt.element_size():
        raise ValueError("dt is not aligned to its type")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64,
             depth: Optional[int] = None):
    """Batched SSD from a zero state. x:[b,s,nh,p] dt:[b,s,nh] A:[nh]
    B,C:[b,s,n]; s a multiple of `chunk`. Returns (y [b,s,nh,p] in x's
    type, h_final [b,nh,p,n] f32).

    `depth` is the number of heads' tiles in flight a block; None solves it
    from `ssd_spec` through `core.autotune.choose_depth`. Either is clamped
    by `plan` and recorded as run, for `autotune.last_choice("ssd_scan")`.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise (`KernelCompileError` / `KernelResourceError` on a failed build or
    launch, ValueError / TypeError on inputs it does not take). Either runs
    under `core.guard` (`ring.guarded`); `ssd_scan_at` launches unguarded.
    """
    _check(x, dt, A, B, C, chunk)
    bsz, s, nh, p = x.shape
    n = B.shape[2]
    spec = ssd_spec(chunk, nh, p, n, x.dtype, seq_len=s)
    if depth is None:
        depth = autotune.choose_depth(spec.profile(), kernel=spec.name,
                                      vars=spec.all_vars())
    run = plan(bsz, s, nh, p, n, x.element_size(), depth)
    cuda = x.device.type == "cuda"
    if not cuda and x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if cuda:
        _check_cuda(x, dt, B, C)
    res = ring.guarded(
        spec, (x, dt, A, B, C),
        lambda d: ssd_scan_at(x, dt, A, B, C, chunk=chunk, depth=d),
        lambda *ops: ssd_scan_plain(*ops, chunk=chunk), cuda=cuda,
        depth=run.depth)
    autotune.record_choice("ssd_scan", res.depth)
    return res.out


def ssd_scan_at(x, dt, A, B, C, *, chunk: int, depth: int,
                group: int = HEAD_GROUP):
    """`ssd_scan` on CUDA tensors at a given depth and head group (no
    solve, no record). One call: `LAUNCHES` kernels, one count."""
    _check(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError("ssd_scan_at takes CUDA tensors")
    _check_cuda(x, dt, B, C)
    bsz, s, nh, p = x.shape
    n = B.shape[2]
    run = plan(bsz, s, nh, p, n, x.element_size(), depth, group)
    y = torch.empty((bsz, s, nh, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((bsz, nh, p, n), dtype=torch.float32,
                          device=x.device)
    if y.numel() == 0:
        return y, h_final.zero_()
    a32 = A.to(torch.float32).contiguous()
    work = torch.empty(run.workspace_bytes // 4, dtype=torch.float32,
                       device=x.device)
    totals = work[bsz * run.chunks * nh * p * n:]
    lib = ring.library(SOURCE, "repro_ssd_scan", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), x.stride(0), x.stride(1),
            dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
            a32.data_ptr(), B.data_ptr(), B.stride(0), B.stride(1),
            C.data_ptr(), C.stride(0), C.stride(1),
            y.data_ptr(), h_final.data_ptr(), work.data_ptr(),
            totals.data_ptr(), bsz, s, nh, p, n, run.depth, run.group,
            ring.DTYPE_CODE[x.dtype], ring.DTYPE_CODE[dt.dtype], stream)
    ring.raise_on_error(err, lib, kernel="ssd_scan", depth=run.depth,
                        tile=(run.chunk, p, n))
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
