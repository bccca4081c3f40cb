"""Paged flash-decode: the kernel's `CoroSpec`, its CUDA wrapper and its
plain PyTorch version.

One decode token per request attends over that request's KV pages, which
the pager scattered across a shared block pool; the block table redirects
every page load. The CUDA kernel (`csrc/paged_decode.cu`, hand-written for
sm_90a) replaces the TPU kernel
``src/repro/kernels/decode_attention/decode_attention.py:paged_flash_decode``
and keeps its arithmetic: q scaled in f32 by ``D**-0.5``, an f32 online
softmax over key positions ``< lengths[b]``, output ``acc / max(l, 1e-30)``
cast to q's type. It is bound by the bytes of the live K/V pages; the
source note says what its design does about that.

`paged_flash_decode` picks its path from the device of the tensors it is
given: on CPU tensors it runs `paged_flash_decode_plain`; on CUDA tensors it
launches the kernel or raises. `paged_flash_decode.launches` counts kernel
launches (and nothing else).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import autotune
from repro_torch.core import context as ctx_mod
from repro_torch.core.coro import CoroSpec, LoadStream
from repro_torch.core.guard import KernelCompileError, KernelResourceError

__all__ = [
    "paged_decode_spec",
    "paged_flash_decode",
    "paged_flash_decode_plain",
    "kernel_depth",
]

NEG_INF = -1e30
SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_decode.cu"
HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 32                 # query heads per KV head the kernel holds
SMEM_LIMIT = 232_448           # shared memory one block may use on sm_90
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# cudaErrorMemoryAllocation, cudaErrorLaunchOutOfResources
_RESOURCE_ERRORS = (2, 701)


def paged_decode_spec(blk: int, kh: int, g: int, d: int, dtype,
                      max_blocks: int) -> CoroSpec:
    """One KV *page* = one coroutine tile, fetched through the block table.

    The same declaration as the reference package's: the K/V page slots are
    private (x depth), the online-softmax accumulators are commutative and
    therefore SHARED (one copy at any depth), and the f32 query is a
    read-only resident counted against the budget. `choose_depth` over this
    spec gives the same depth in both packages under one `MachineModel`.
    `max_blocks` (the table width) is the tile count; it does not change the
    declaration.
    """
    h = kh * g
    return CoroSpec(
        name="paged_decode",
        loads=(
            LoadStream("k", (1, blk, kh, d), dtype),
            LoadStream("v", (1, blk, kh, d), dtype),
        ),
        vars=(
            ctx_mod.var("m", (kh, g), "float32",
                        carries_dependence=True, commutative=True),
            ctx_mod.var("l", (kh, g), "float32",
                        carries_dependence=True, commutative=True),
            ctx_mod.var("acc", (kh, g, d), "float32",
                        carries_dependence=True, commutative=True),
            ctx_mod.VarSpec("q_f32", nbytes=4 * (h * d + kh * g * d),
                            read_only=True),
        ),
        flops_per_tile=float(4 * blk * h * d),
    )


# ------------------------------------------------------------ plain version


def paged_flash_decode_plain(q, k_pool, v_pool, block_tables, lengths):
    """The kernel's function in plain PyTorch, with the same f32 arithmetic
    (a one-pass softmax in place of the online one: equal up to rounding).

    q: [B, H, D]; k_pool/v_pool: [NB, blk, KH, D]; block_tables: [B, M]
    int32 (padded with the garbage page 0); lengths: [B] int32 — request b
    attends key positions < lengths[b]. Returns [B, H, D] in q's type; rows
    with lengths == 0 are finite garbage (round padding)."""
    b, h, d = q.shape
    blk, kh = k_pool.shape[1], k_pool.shape[2]
    m = block_tables.shape[1]
    g = h // kh
    qv = q.float().reshape(b, kh, g, d) * (d ** -0.5)
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, m * blk, kh, d).float()
    v = v_pool[bt].reshape(b, m * blk, kh, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qv, k)
    pos = torch.arange(m * blk, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]      # [B, S]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


# ------------------------------------------------------------- the kernel


def _smem_bytes(g: int, d: int, blk: int, depth: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (the layout in the .cu source)."""
    return 2 * depth * blk * d * itemsize + 4 * (g * d + g * blk + 2 * g)


def kernel_depth(depth: int, *, g: int, d: int, blk: int, itemsize: int,
                 n_tiles: int) -> int:
    """Clamp a solved depth to what the kernel runs: at most `n_tiles`
    pages, and no more page buffers than one block's shared memory holds
    for its own [blk, D] K/V tile."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    fixed = _smem_bytes(g, d, blk, 0, itemsize)
    per_slot = _smem_bytes(g, d, blk, 1, itemsize) - fixed
    fit = (SMEM_LIMIT - fixed) // per_slot
    if fit < 1:
        raise KernelResourceError(
            f"one page buffer needs {fixed + per_slot} B of shared memory, "
            f"over {SMEM_LIMIT}", kernel="paged_decode", depth=1,
            tile=(blk, d))
    return max(1, min(int(depth), fit, max(int(n_tiles), 1)))


def _library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load(SOURCE)
    fn = lib.repro_paged_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pool, v_pool, block_tables, lengths) -> None:
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"need q [B,H,D] and pools [NB,blk,KH,D], got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} != v_pool "
                         f"{tuple(v_pool.shape)}")
    b, h, d = q.shape
    kh = k_pool.shape[2]
    if k_pool.shape[3] != d or h % kh:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be [B={b}, M], got "
                         f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B={b}], got {tuple(lengths.shape)}")


def _check_cuda(q, k_pool, v_pool, block_tables, lengths) -> None:
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must match "
                        f"q ({q.dtype})")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    d = q.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.shape[1] // k_pool.shape[2] > MAX_GROUP:
        raise ValueError(f"more than {MAX_GROUP} query heads per KV head")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async)")


def paged_flash_decode(q, k_pool, v_pool, block_tables, lengths, *,
                       depth: Optional[int] = None):
    """Flash-decode over a paged KV pool with ragged per-request lengths.

    q: [B,H,D]; k_pool/v_pool: [NB, blk, KH, D]; block_tables: [B, M] int32
    (pad with the reserved garbage block 0); lengths: [B] int32 — request b
    attends key positions < lengths[b]. Returns [B,H,D]; rows with
    lengths == 0 are garbage (round padding slots).

    `depth` is the number of pages in flight; None solves it from
    `paged_decode_spec` through `core.autotune.choose_depth`. The kernel
    clamps it to what shared memory holds (`kernel_depth`).

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise (`KernelCompileError` / `KernelResourceError` on a failed build or
    launch, ValueError / TypeError on inputs it does not take).
    """
    if depth is not None and depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    _check(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type == "cpu":
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                        ("block_tables", block_tables), ("lengths", lengths)):
            if t.device.type != "cpu":
                raise ValueError(f"{name} is on {t.device}, q on the CPU")
        return paged_flash_decode_plain(q, k_pool, v_pool, block_tables,
                                        lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda(q, k_pool, v_pool, block_tables, lengths)

    b, h, d = q.shape
    blk, kh = k_pool.shape[1], k_pool.shape[2]
    m = block_tables.shape[1]
    g = h // kh
    out = torch.empty_like(q)
    if b == 0:
        return out
    itemsize = q.element_size()
    if depth is None:
        spec = paged_decode_spec(blk, kh, g, d, q.dtype, max_blocks=m)
        depth = autotune.choose_depth(spec.profile(), kernel=spec.name,
                                      vars=spec.all_vars())
    depth = kernel_depth(depth, g=g, d=d, blk=blk, itemsize=itemsize,
                         n_tiles=m)
    autotune.record_choice("paged_decode", depth)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kh, d, blk, m, depth, float(d ** -0.5),
            _DTYPE_CODE[q.dtype], stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        cls = KernelResourceError if err in _RESOURCE_ERRORS else \
            KernelCompileError
        raise cls(f"paged_decode launch failed: CUDA error {err} ({msg})",
                  kernel="paged_decode", depth=depth, tile=(blk, d))
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
