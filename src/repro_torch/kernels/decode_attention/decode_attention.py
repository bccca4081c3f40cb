"""Flash-decode attention, dense and paged: each kernel's `CoroSpec`, its
CUDA wrapper and its plain PyTorch version.

Dense (`flash_decode`, K3): one decode token per sequence attends over a
dense ``[B, S, KH, D]`` cache up to one scalar position ``pos``. It
replaces the TPU kernel
``src/repro/kernels/decode_attention/decode_attention.py:flash_decode``;
the dense serving engine runs it for every attention layer of every
decode step.

Paged (`paged_flash_decode`, K1): one decode token per request attends
over that request's KV pages, which the pager scattered across a shared
block pool; the block table redirects every row, and each request has its
own length. It replaces the TPU kernel
``src/repro/kernels/decode_attention/decode_attention.py:paged_flash_decode``;
the paged serving engine runs it for every attention layer of every round.

One CUDA source (`csrc/flash_decode.cu`), hand-written for sm_90a, runs
both: one split kernel and one merge kernel, instantiated with two row
functions (dense rows, or pages through the block table) and two length
sources (``min(pos + 1, S)`` for the batch, or ``lengths[b]``, both read
on the device, so that a captured launch replays any step). Both keep the
TPU kernels' arithmetic: scores scaled in f32 by
``D**-0.5``, an f32 online softmax over the live keys, output
``acc / max(l, 1e-30)`` cast to q's type; the sequence is split over
blocks in ``blk``-row tiles and the splits' partial softmax states merged;
in bf16 P is rounded to bf16 for the tensor cores, as the reference
engine's decode attention does. Both are bound by the bytes of the live
K/V rows; the source notes say what the design does about that.

Each wrapper picks its path from the device of the tensors it is given: on
CPU tensors it runs its plain version; on CUDA tensors it launches the
kernel or raises; either under `core.guard` (`ring.guarded`: the depth
ladder, the scan, the sentinel). `flash_decode_at` and
`paged_flash_decode_at` launch the kernel at a given depth and split,
unguarded. `flash_decode.launches` and `paged_flash_decode.launches`
count kernel calls (and nothing else).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core import context as ctx_mod
from repro_torch.core.coro import CoroSpec, LoadStream
from repro_torch.core.guard import KernelResourceError
from repro_torch.kernels import ring

__all__ = [
    "decode_spec",
    "flash_decode",
    "flash_decode_cost",
    "flash_decode_at",
    "flash_decode_plain",
    "flash_kernel_depth",
    "paged_decode_cost",
    "paged_decode_spec",
    "paged_flash_decode",
    "paged_flash_decode_at",
    "paged_flash_decode_plain",
    "kernel_depth",
    "ring_pages",
    "split_plan",
]

NEG_INF = -1e30
FLASH_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 32                 # query heads per KV head the kernel holds
MAX_GROUP_WIDE = 16            # ... at head_dim 256 (csrc: kMaxGroupWide)
FLASH_BLK = 64                 # default tile height (the sweep: PERF.md)
BLOCKS_PER_SM = 2              # what the split plan aims to put on each SM
WARPS = 4                      # kWarps in csrc/flash_decode.cu


def _softmax_vars(kh: int, g: int, d: int):
    """The online-softmax state (commutative: SHARED, one copy at any
    depth) and the f32 query, a read-only resident."""
    h = kh * g
    return (
        ctx_mod.var("m", (kh, g), "float32",
                    carries_dependence=True, commutative=True),
        ctx_mod.var("l", (kh, g), "float32",
                    carries_dependence=True, commutative=True),
        ctx_mod.var("acc", (kh, g, d), "float32",
                    carries_dependence=True, commutative=True),
        ctx_mod.VarSpec("q_f32", nbytes=4 * (h * d + kh * g * d),
                        read_only=True),
    )


def decode_spec(blk: int, kh: int, g: int, d: int, dtype) -> CoroSpec:
    """KV block tile: k+v copies per slot; accumulators are
    depth-independent. The same declaration as the reference package's,
    so `choose_depth` gives the same depth in both under one
    `MachineModel`. The CUDA kernel's tile is one KV head's ``[blk, D]``
    rows of the declared ``[blk, KH, D]`` tile (one block per KV head)."""
    return CoroSpec(
        name="flash_decode",
        loads=(
            LoadStream("k", (blk, kh, d), dtype),
            LoadStream("v", (blk, kh, d), dtype),
        ),
        vars=_softmax_vars(kh, g, d),
        flops_per_tile=float(4 * blk * kh * g * d),  # qk + pv per block
    )


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
    return CoroSpec(
        name="paged_decode",
        loads=(
            LoadStream("k", (1, blk, kh, d), dtype),
            LoadStream("v", (1, blk, kh, d), dtype),
        ),
        vars=_softmax_vars(kh, g, d),
        flops_per_tile=float(4 * blk * kh * g * d),
    )


# ------------------------------------------------------------ plain versions


def flash_decode_plain(q, k_cache, v_cache, pos, return_lse: bool = False):
    """The dense kernel's function in plain PyTorch, with the same f32
    arithmetic (a one-pass softmax in place of the online one: equal up to
    rounding).

    q: [B, H, D]; k_cache/v_cache: [B, S, KH, D]; pos: the last key
    position attended (every key when pos >= S - 1; none when it is
    negative, and the output is then 0), an int or a one-element integer
    tensor, never read on the host. Returns [B, H, D] in q's type, and with
    `return_lse` also each head's f32 log-sum-exp of its scaled scores over
    the live keys, [B, H] (-inf where none is live)."""
    b, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    qv = q.float().reshape(b, kh, h // kh, d) * (d ** -0.5)
    sc = torch.einsum("bkgd,bskd->bkgs", qv, k_cache.float())
    valid = torch.arange(s, device=q.device) <= pos
    sc = sc.masked_fill(~valid, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m[..., 0] + torch.log(l),
                      torch.full_like(l, float("-inf")))
    return out, lse.reshape(b, h)


def _finite_lse(out):
    """(o, lse) with lse's -inf (a head with no live key) as NEG_INF: what
    the guard's scan and sentinel read of a call that returns its lse (a
    NaN stays NaN)."""
    o, lse = out
    return o, torch.where(lse == float("-inf"), torch.full_like(lse, NEG_INF),
                          lse)


def _plain_with_lse(q, k_cache, v_cache, pos):
    return flash_decode_plain(q, k_cache, v_cache, pos, return_lse=True)


def _finite_plain_lse(q, k_cache, v_cache, pos):
    """The sentinel's reference of a call that returns its lse."""
    return _finite_lse(_plain_with_lse(q, k_cache, v_cache, pos))


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


# ------------------------------------------------ the kernel's host side

_FLASH_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def split_plan(b: int, kh: int, s: int, blk: int, sm_count: int,
               splits: Optional[int] = None):
    """(n_split, tiles per split) of the kernel's grid (B * KH, n_split):
    the ceil(S / blk) tiles of the rows the cache holds (S, or M * page for
    a paged one) cut into contiguous runs, as few splits as put
    `BLOCKS_PER_SM` blocks on each of `sm_count` SMs (one split when B * KH
    alone does), or `splits` when given. Depends on S, never on pos or the
    lengths; every split holds at least one tile."""
    n_tiles = -(-s // blk)
    if splits is None:
        splits = -(-BLOCKS_PER_SM * sm_count // max(b * kh, 1))
    per = -(-n_tiles // max(1, min(int(splits), n_tiles)))
    return -(-n_tiles // per), per


def _flash_smem_bytes(g: int, d: int, blk: int, depth: int, itemsize: int,
                      slots: int = 0) -> int:
    """Dynamic shared memory of one block (the layout in
    csrc/flash_decode.cu): a paged block's `slots` table entries, then the
    K/V ring, rows padded by 16 bytes, or the warps' f32 states for the
    block's merge (head rows padded by 8 floats), whichever is larger."""
    gp = -(-g // 16) * 16 if itemsize == 2 else 1 << (g - 1).bit_length()
    ring_bytes = 2 * depth * blk * (d + 16 // itemsize) * itemsize
    return 4 * slots + max(ring_bytes, 4 * WARPS * gp * (d + 8 + 2))


def flash_kernel_depth(depth: int, *, g: int, d: int, blk: int,
                       itemsize: int, n_tiles: int, slots: int = 0,
                       kernel: str = "flash_decode") -> int:
    """Clamp a depth in tiles to what the kernel runs: at most `n_tiles`
    tiles (those of one split that can hold a live key), at most
    `ring.MAX_DEPTH`, and no more K/V tile pairs than one block's shared
    memory holds beside a paged block's `slots` table entries."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    need = _flash_smem_bytes(g, d, blk, 1, itemsize, slots)
    if need > ring.SMEM_LIMIT:
        raise KernelResourceError(
            f"one K/V tile pair needs {need} B of shared memory, over "
            f"{ring.SMEM_LIMIT}", kernel=kernel, depth=1, tile=(blk, d),
            refused=True)
    fit = (ring.SMEM_LIMIT - 4 * slots) // (
        2 * blk * (d + 16 // itemsize) * itemsize)
    return max(1, min(int(depth), ring.MAX_DEPTH, fit, max(int(n_tiles), 1)))


def _check_dense(q, k_cache, v_cache, blk: int) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"need q [B,H,D] and caches [B,S,KH,D], got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} != v_cache "
                         f"{tuple(v_cache.shape)}")
    b, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or \
            h % k_cache.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)}")
    if blk < 1:
        raise ValueError(f"blk must be >= 1, got {blk}")


def _check_cuda(q, k, v, blk: int, names=("k_cache", "v_cache")) -> None:
    """What the kernel takes on the card; `names` are the K/V operands'."""
    if q.dtype not in ring.DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{names[0]}/{names[1]} ({k.dtype}, {v.dtype}) must "
                        f"match q ({q.dtype})")
    d = q.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {FLASH_HEAD_DIMS}")
    most = MAX_GROUP_WIDE if d > 128 else MAX_GROUP
    if q.shape[1] // k.shape[2] > most:
        raise ValueError(f"more than {most} query heads per KV head at "
                         f"head_dim {d}")
    if blk % 16:
        raise ValueError(f"blk must be a multiple of 16 (a warp's rows), "
                         f"got {blk}")
    for name, t in zip(names, (k, v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async)")


def flash_decode_cost(b: int, h: int, kh: int, d: int, live: int,
                      itemsize: int, lse: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of dense decode attention over `live` key rows of
    each of `b` caches: the live K and V rows, q and the output read or
    written once (and the f32 lse with `lse`); q.k and p.v, two flops a
    multiply-add. The bound of `chip_smoke.py` and the dry-run's count."""
    nbytes = 2 * b * live * kh * d * itemsize + 2 * b * h * d * itemsize
    if lse:
        nbytes += b * h * 4
    return 4 * b * h * d * live, nbytes


def paged_decode_cost(b: int, h: int, kh: int, d: int, m: int, live: int,
                      itemsize: int) -> Tuple[int, int]:
    """(flops, bytes) of paged decode attention for `b` requests with
    `live` key rows in all (the sum of their lengths) and block tables `m`
    pages wide: the live K and V rows, q, the output, the int32 table and
    lengths read or written once; q.k and p.v. The bound of
    `chip_smoke.py` and the dry-run's count."""
    nbytes = (2 * live * kh * d * itemsize + 2 * b * h * d * itemsize
              + b * m * 4 + b * 4)
    return 4 * h * d * live, nbytes


def flash_decode(q, k_cache, v_cache, pos, *, blk: int = FLASH_BLK,
                 depth: Optional[int] = None, splits: Optional[int] = None,
                 return_lse: bool = False):
    """Flash-decode over a dense KV cache at one scalar position.

    q: [B, H, D]; k_cache/v_cache: [B, S, KH, D]; pos: the last key
    position attended — every position <= pos (all S when pos >= S). S
    need not be a multiple of `blk`. Returns [B, H, D] in q's type; with
    `return_lse`, (out, lse): lse [B, H] f32, each head's log-sum-exp of
    its scaled scores over the live keys, -inf (and out 0) where no key is
    live. A sequence-sharded decode merges its shards' (out, lse)
    (`models.common._decode_core`).

    `pos` is a Python int >= 0, or a one-element int32 tensor on q's
    device, which the kernel reads on the device, as the reference's Pallas
    kernel reads its scalar-prefetched `pos`: the host never reads a tensor
    `pos`, so a captured launch reads each replay's value (an int is
    written to the device first). A negative tensor `pos` attends no key
    (0 on the card).

    On the card the sequence is split over `splits` blocks per (b, kh);
    None takes `split_plan` for this card's SM count. The plain version
    does not split (one split). `depth` is the number of `blk`-row tiles in
    flight per block; None solves it from `decode_spec` through
    `core.autotune.choose_depth`. Either is clamped by `flash_kernel_depth`
    to the tiles of one split that can hold a live key (an int `pos` bounds
    them; a tensor `pos`, which the host does not read, leaves the split's
    tiles, as the reference's ``n_tiles`` is S's) and recorded as run, for
    `autotune.last_choice("flash_decode")`.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise (`KernelCompileError` / `KernelResourceError` on a failed build or
    launch, ValueError / TypeError on inputs it does not take).
    """
    pos, way = _dense_args(q, k_cache, v_cache, pos, blk, splits)
    on_device = isinstance(pos, torch.Tensor)
    b, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    if way == "meta":     # a tensor pos holds no data: every row counts
        live = s if on_device else min(pos + 1, s)

        def empty():
            out = torch.empty_like(q)
            return (out, torch.empty(b, h, dtype=torch.float32,
                                     device="meta")) if return_lse else out
        return ring.meta_call("flash_decode", flash_decode_cost(
            b, h, kh, d, live, k_cache.element_size(), return_lse), empty,
            (q, k_cache, v_cache, pos))
    on_card = way == "cuda"
    if on_card:
        n_split, per = split_plan(b, kh, s, blk, ring.sm_count(q.device),
                                  splits)
    else:
        n_split, per = split_plan(b, kh, s, blk, 0, splits or 1)
    spec = decode_spec(blk, kh, g, d, k_cache.dtype)
    if depth is None:
        depth = autotune.choose_depth(spec.profile(), kernel=spec.name,
                                      vars=spec.all_vars())
    live = per if on_device else min(per, -(-min(pos + 1, s) // blk))
    depth = flash_kernel_depth(depth, g=g, d=d, blk=blk,
                               itemsize=k_cache.element_size(), n_tiles=live)
    if on_card:
        _check_cuda(q, k_cache, v_cache, blk)
    if return_lse:   # the scan and the sentinel read lse's -inf as finite
        extra = dict(reference=_finite_plain_lse, written=_finite_lse)
        plain = _plain_with_lse
    else:
        extra, plain = {}, flash_decode_plain
    res = ring.guarded(
        spec, (q, k_cache, v_cache, pos),
        lambda k: flash_decode_at(q, k_cache, v_cache, pos, blk=blk,
                                  depth=k, splits=n_split,
                                  return_lse=return_lse),
        plain, cuda=on_card, depth=depth, **extra)
    autotune.record_choice(spec.name, res.depth)
    return res.out


def _dense_args(q, k_cache, v_cache, pos, blk: int, splits):
    """(pos as an int or a 0-d int32 tensor, the call's `ring.route`) of a
    dense flash-decode call; raises on what it does not take."""
    _check_dense(q, k_cache, v_cache, blk)
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int32:
            raise ValueError(f"a tensor pos must be one int32 element, got "
                             f"{pos.dtype} {tuple(pos.shape)}")
        pos = pos.reshape(())
    else:
        pos = int(pos)
        if pos < 0:
            raise ValueError(f"pos must be >= 0, got {pos}")
    if splits is not None and splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    way = ring.route("flash_decode", ("q", q), ("k_cache", k_cache),
                     ("v_cache", v_cache),
                     *([("pos", pos)] if isinstance(pos, torch.Tensor)
                       else []))
    return pos, way


def flash_decode_at(q, k_cache, v_cache, pos, *, blk: int = FLASH_BLK,
                    depth: int, splits: Optional[int] = None,
                    return_lse: bool = False):
    """`flash_decode` on CUDA tensors with `depth` tiles in flight per block
    and the sequence in `splits` splits (None: `split_plan`'s); no solve,
    no record, no guard. Returns out, or (out, lse) with `return_lse`.
    Counts one launch."""
    pos, way = _dense_args(q, k_cache, v_cache, pos, blk, splits)
    if way != "cuda":
        raise ValueError("flash_decode_at takes CUDA tensors")
    _check_cuda(q, k_cache, v_cache, blk)
    if not 1 <= depth <= ring.MAX_DEPTH:
        raise ValueError(f"depth must be in [1, {ring.MAX_DEPTH}], got "
                         f"{depth}")
    b, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    n_split, per = split_plan(b, kh, s, blk, ring.sm_count(q.device), splits)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b == 0:
        return (out, lse) if return_lse else out
    part = torch.empty(b * kh * n_split * g * (d + 2), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    if not isinstance(pos, torch.Tensor):   # the kernel reads it on the card
        pos = torch.full((), min(pos, s), dtype=torch.int32, device=q.device)
    lib = ring.library(FLASH_SOURCE, "repro_flash_decode", _FLASH_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if part is None else part.data_ptr(),
            pos.data_ptr(), b, h, kh, d, s, blk, n_split, per, depth,
            float(d ** -0.5), ring.DTYPE_CODE[q.dtype], stream)
    ring.raise_on_error(err, lib, kernel="flash_decode", depth=depth,
                        tile=(blk, d))
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0


# ------------------------------------------------------- the paged kernel


def _table_slots(m: int, page: int, blk: int, per: int) -> int:
    """Block-table entries a paged block holds in shared memory: every page
    its split's `per` tiles of `blk` rows can touch, at most the table width
    `m`, rounded up to four (csrc/flash_decode.cu:table_slots)."""
    n = min(m, (per * blk - 1) // page + 2)
    return -(-n // 4) * 4


def kernel_depth(depth: int, *, g: int, d: int, page: int, blk: int,
                 itemsize: int, n_tiles: int, m: int) -> int:
    """The paged kernel's ring in tiles for a depth of `depth` pages (the
    unit `paged_decode_spec` solves in): the tiles those pages' rows fill,
    at least one, clamped by `flash_kernel_depth` to the `n_tiles` tiles of
    one split and to one block's shared memory beside its slice of the
    `m`-wide block table. The depth that runs, in pages, is
    `ring_pages(tiles, blk, page)`."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    return flash_kernel_depth(
        max(1, int(depth) * page // blk), g=g, d=d, blk=blk,
        itemsize=itemsize, n_tiles=n_tiles,
        slots=_table_slots(m, page, blk, n_tiles), kernel="paged_decode")


def ring_pages(tiles: int, blk: int, page: int) -> int:
    """A ring of `tiles` tiles of `blk` rows, in pages (at least one)."""
    return max(1, tiles * blk // page)


def _check_paged(q, k_pool, v_pool, block_tables, lengths, blk: int) -> None:
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
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            block_tables.shape[1] < 1:
        raise ValueError(f"block_tables must be [B={b}, M >= 1], got "
                         f"{tuple(block_tables.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [B={b}], got {tuple(lengths.shape)}")
    if blk < 1:
        raise ValueError(f"blk must be >= 1, got {blk}")


def paged_flash_decode(q, k_pool, v_pool, block_tables, lengths, *,
                       blk: int = FLASH_BLK, depth: Optional[int] = None,
                       splits: Optional[int] = None):
    """Flash-decode over a paged KV pool with ragged per-request lengths.

    q: [B,H,D]; k_pool/v_pool: [NB, page, KH, D] (any page size);
    block_tables: [B, M] int32 (pad with the reserved garbage block 0);
    lengths: [B] int32 — request b attends key positions < lengths[b].
    Returns [B,H,D]; rows with lengths == 0 (round padding) are finite (0
    on the card).

    On the card the rows the table can hold, M * page, are split over
    `splits` blocks per (b, kh) in `blk`-row tiles; None takes `split_plan`
    for this card's SM count. The grid and the plan never depend on
    `lengths` or `block_tables`, which the host never reads: each split
    finds its live rows on the device. The plain version does not split.
    `depth` is the number of pages in flight; None solves it from
    `paged_decode_spec` through `core.autotune.choose_depth`. Either is
    turned into ring tiles by `kernel_depth` (at most one split's tiles)
    and recorded in pages as run (`ring_pages`), for
    `autotune.last_choice("paged_decode")`.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise (`KernelCompileError` / `KernelResourceError` on a failed build or
    launch, ValueError / TypeError on inputs it does not take).
    """
    if depth is not None and depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if splits is not None and splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    _check_paged(q, k_pool, v_pool, block_tables, lengths, blk)
    way = ring.route("paged_decode", ("q", q), ("k_pool", k_pool),
                     ("v_pool", v_pool), ("block_tables", block_tables),
                     ("lengths", lengths))
    b, h, d = q.shape
    page, kh = k_pool.shape[1], k_pool.shape[2]
    m = block_tables.shape[1]
    g = h // kh
    if way == "meta":     # lengths hold no data: every table row counts
        return ring.meta_call("paged_decode", paged_decode_cost(
            b, h, kh, d, m, b * m * page, k_pool.element_size()),
            lambda: torch.empty_like(q),
            (q, k_pool, v_pool, block_tables, lengths))
    on_card = way == "cuda"
    if on_card:
        n_split, per = split_plan(b, kh, m * page, blk,
                                  ring.sm_count(q.device), splits)
    else:
        n_split, per = split_plan(b, kh, m * page, blk, 0, splits or 1)
    spec = paged_decode_spec(page, kh, g, d, k_pool.dtype, max_blocks=m)
    if depth is None:
        depth = autotune.choose_depth(spec.profile(), kernel=spec.name,
                                      vars=spec.all_vars())

    def tiles_of(pages: int) -> int:
        return kernel_depth(pages, g=g, d=d, page=page, blk=blk,
                            itemsize=k_pool.element_size(), n_tiles=per, m=m)

    pages = ring_pages(tiles_of(depth), blk, page)
    if on_card:
        _check_cuda(q, k_pool, v_pool, blk, names=("k_pool", "v_pool"))
        if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
            raise TypeError("block_tables and lengths must be int32")
    ops = (q, k_pool, v_pool, block_tables, lengths)
    res = ring.guarded(
        spec, ops,
        lambda p: paged_flash_decode_at(*ops, blk=blk, tiles=tiles_of(p),
                                        splits=n_split),
        paged_flash_decode_plain, cuda=on_card, depth=pages,
        reference=_live_plain, written=lambda out: _live_rows(out, ops[4]))
    autotune.record_choice(spec.name,
                           ring_pages(tiles_of(res.depth), blk, page))
    return res.out


def _live_rows(out, lengths):
    """`out` with the rows of zero-length requests (round padding) set to
    0, on the device (no host read): what the guard's scan and sentinel
    compare. A padding row is the kernel's 0 and the plain version's
    finite garbage, and no caller reads it."""
    return torch.where((lengths > 0)[:, None, None], out, out.new_zeros(()))


def _live_plain(q, k_pool, v_pool, block_tables, lengths):
    """The sentinel's reference: the plain version's live rows."""
    return _live_rows(paged_flash_decode_plain(q, k_pool, v_pool,
                                               block_tables, lengths),
                      lengths)


def paged_flash_decode_at(q, k_pool, v_pool, block_tables, lengths, *,
                          blk: int = FLASH_BLK, tiles: int,
                          splits: Optional[int] = None):
    """`paged_flash_decode` on CUDA tensors with a ring of `tiles` tiles of
    `blk` rows a block and the table's rows in `splits` splits (None:
    `split_plan`'s); no solve, no record, no guard. Counts one launch."""
    if splits is not None and splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    _check_paged(q, k_pool, v_pool, block_tables, lengths, blk)
    if ring.route("paged_decode", ("q", q), ("k_pool", k_pool),
                  ("v_pool", v_pool), ("block_tables", block_tables),
                  ("lengths", lengths)) != "cuda":
        raise ValueError("paged_flash_decode_at takes CUDA tensors")
    _check_cuda(q, k_pool, v_pool, blk, names=("k_pool", "v_pool"))
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if not 1 <= tiles <= ring.MAX_DEPTH:
        raise ValueError(f"tiles must be in [1, {ring.MAX_DEPTH}], got "
                         f"{tiles}")
    b, h, d = q.shape
    page, kh = k_pool.shape[1], k_pool.shape[2]
    m = block_tables.shape[1]
    g = h // kh
    n_split, per = split_plan(b, kh, m * page, blk, ring.sm_count(q.device),
                              splits)
    out = torch.empty_like(q)
    if b == 0:
        return out
    part = torch.empty(b * kh * n_split * g * (d + 2), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    lib = ring.library(FLASH_SOURCE, "repro_paged_flash_decode",
                       _PAGED_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_flash_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            b, h, kh, d, page, m, blk, n_split, per, tiles,
            float(d ** -0.5), ring.DTYPE_CODE[q.dtype], stream)
    ring.raise_on_error(err, lib, kernel="paged_decode", depth=tiles,
                        tile=(blk, d))
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
