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
each weight row: 64 rows in bf16, 32 in f32); each block keeps the solved
number of k-slices in flight, clamped by `kernel_depth` to what one block's
shared memory holds, to the k-slices of an output tile and to
`ring.MAX_DEPTH`.

Grid: persistent. `walk` deals the output tiles (expert, column tile,
token tile) to the blocks in turn, and each block walks the k-slices of
its tiles in order and stores each tile whole. `grid_blocks` sizes the
grid to the card (`sm_count x blocks_per_sm`): the fewest blocks that walk
the tiles in the fewest tiles a block. A call is one launch.

`gmm` picks its path from the device of the tensors it is given: on CPU
tensors it runs `gmm_plain`; on CUDA tensors it launches the kernel or
raises. `gmm.launches` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core import context as ctx_mod
from repro_torch.core.coro import CoroSpec, LoadStream
from repro_torch.core.guard import KernelResourceError
from repro_torch.kernels import ring

__all__ = ["F_TILE", "Walk", "blocks_per_sm", "cost", "gmm", "gmm_at",
           "gmm_plain",
           "gmm_spec", "grid_blocks", "grid_for", "kernel_depth", "n_slices",
           "slot_bytes", "walk"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
F_TILE = 128                   # kBN in the .cu source: columns per tile
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])
_OCCUPANCY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
ALIGN_SLACK = 1024             # kAlignSlack: aligns the slots, once a block


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
    """Shared memory of one ring slot: the [BK, 128] weight slice (16 KiB,
    swizzled, no pad) and the [16 MT, BK] token slice (rows padded by 16
    bytes), rounded up to 1024 bytes, and the slot's two 8-byte mbarriers
    (the .cu's Ring and kBarrierBytes). A block adds `ALIGN_SLACK`."""
    bk, pad = _slice_rows(itemsize), 16 // itemsize
    data = (bk * F_TILE + 16 * _token_tiles(c) * (bk + pad)) * itemsize
    return -(-data // 1024) * 1024 + 16


def n_slices(dm: int, itemsize: int) -> int:
    """k-slices of one output tile (the ring's tiles)."""
    return -(-dm // _slice_rows(itemsize))


@dataclasses.dataclass(frozen=True)
class Walk:
    """The persistent grid's walk (`csrc/moe_gmm.cu`): `tiles` output
    tiles of `per_tile` k-slices each, numbered (expert, column tile, token
    tile) with the token tile fastest. Block b walks tiles b, b + blocks,
    b + 2 blocks, ... (so the blocks in flight together read neighbouring
    tiles of one expert), each tile's k-slices in order, and stores each
    tile whole: no tile is split between blocks."""
    blocks: int
    tiles: int
    per_tile: int
    n_col: int
    n_tok: int

    def tiles_of(self, b: int) -> range:
        return range(b, self.tiles, self.blocks)

    @property
    def slices(self) -> int:
        return self.tiles * self.per_tile


def grid_blocks(tiles: int, capacity: int) -> int:
    """The grid of a walk over `tiles` output tiles on a card that holds
    `capacity` blocks at once: the fewest blocks that walk them in the
    fewest tiles a block, ceil(tiles / capacity) (one tile a block when
    they fit at once), so that no block walks more tiles than it must and
    the blocks' shares differ by at most one tile."""
    per_block = -(-tiles // capacity)
    return -(-tiles // per_block)


def walk(e: int, c: int, dm: int, f: int, itemsize: int,
         blocks: int) -> Walk:
    """The walk of `blocks` blocks (at most one per tile) over
    [E, C, dm] x [E, dm, f] in 16 MT-row token tiles, 128-column tiles and
    k-slices of 128 bytes a weight row (one, zero-filled, when dm = 0)."""
    per_tile = max(1, n_slices(dm, itemsize))
    n_col, n_tok = -(-f // F_TILE), -(-c // (16 * _token_tiles(c)))
    tiles = e * n_col * n_tok
    if blocks < 1 or tiles < 1:
        raise ValueError(f"need blocks >= 1 and work, got {blocks} blocks "
                         f"over {tiles} tiles")
    return Walk(min(blocks, tiles), tiles, per_tile, n_col, n_tok)


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


def cost(e: int, c: int, dm: int, f: int, itemsize: int,
         shared: bool) -> Tuple[int, int]:
    """(flops, bytes) of ``out[e] = tokens[e] @ weights[e]`` for `e`
    experts of [c, dm] x [dm, f]: the weights, the tokens (one [c, dm]
    block when `shared` by every expert, one an expert otherwise) and the
    [e, c, f] output, each read or written once; 2 e c dm f flops. The
    bound of `chip_smoke.py` and the dry-run's count."""
    nbytes = (e * dm * f + (1 if shared else e) * c * dm + e * c * f) \
        * itemsize
    return 2 * e * c * dm * f, nbytes


def gmm(tokens: torch.Tensor, weights: torch.Tensor, *, f_tile: int = F_TILE,
        depth: Optional[int] = None) -> torch.Tensor:
    """tokens: [E, C, dm] (any expert and row stride, 0 included);
    weights: [E, dm, f] -> [E, C, f] in the token type.

    `depth` is the number of k-slices in flight per block; None solves it
    from `gmm_spec` through `core.autotune.choose_depth`. Either is clamped
    by `kernel_depth` and recorded as run, for
    `autotune.last_choice("moe_gmm")`. The grid is `grid_for`'s.

    CPU tensors take the plain version. CUDA tensors launch the kernel, or
    raise (`KernelCompileError` / `KernelResourceError` on a failed build or
    launch, ValueError / TypeError on inputs it does not take). Either runs
    under `core.guard` (`ring.guarded`); `gmm_at` launches unguarded.
    """
    _check(tokens, weights)
    e, c, dm = tokens.shape
    f = weights.shape[2]
    itemsize = tokens.element_size()
    way = ring.route("moe_gmm", ("tokens", tokens), ("weights", weights),
                     contiguous=False)
    if way == "meta":
        shared = e > 1 and tokens.stride(0) == 0
        return ring.meta_call(
            "moe_gmm", cost(e, c, dm, f, itemsize, shared),
            lambda: torch.empty((e, c, f), dtype=tokens.dtype,
                                device="meta"), (tokens, weights))
    spec = gmm_spec(c, dm, f_tile, weights.dtype, f_total=f)
    depth = ring.solve_depth(spec, depth, slot_bytes=slot_bytes(c, itemsize),
                             n_tiles=n_slices(dm, itemsize))
    cuda = way == "cuda"
    if cuda:
        _check_cuda(tokens, weights, f_tile)
    res = ring.guarded(spec, (tokens, weights),
                       lambda d: _launch(tokens, weights, d, None),
                       gmm_plain, cuda=cuda, depth=depth)
    autotune.record_choice(spec.name, res.depth)
    return res.out


def _library() -> ctypes.CDLL:
    lib = ring.library(SOURCE, "repro_moe_gmm", _ARGTYPES)
    occ = lib.repro_moe_gmm_occupancy
    if occ.argtypes is None:
        occ.argtypes = _OCCUPANCY_ARGTYPES
        occ.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _occupancy(device: int, dtype_code: int, mt: int, vec: bool,
               depth: int) -> int:
    lib = _library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.repro_moe_gmm_occupancy(dtype_code, mt, int(vec), depth,
                                          ctypes.byref(n))
    rows = _slice_rows(4 if dtype_code == ring.DTYPE_CODE[torch.float32]
                       else 2)
    ring.raise_on_error(err, lib, kernel="moe_gmm", depth=depth,
                        tile=(rows, F_TILE))
    if n.value < 1:
        raise KernelResourceError(
            f"no block of the kernel fits an SM at depth {depth}",
            kernel="moe_gmm", depth=depth, tile=(rows, F_TILE), refused=True)
    return n.value


def blocks_per_sm(tokens: torch.Tensor, weights: torch.Tensor,
                  depth: int) -> int:
    """The kernel's blocks that fit one SM at once at `depth` (registers,
    shared memory and threads, from the CUDA occupancy calculator: at C 32
    registers allow fewer blocks than shared memory does), read once per
    device and configuration."""
    dev = tokens.device
    return _occupancy(dev.index if dev.index is not None
                      else torch.cuda.current_device(),
                      ring.DTYPE_CODE[tokens.dtype],
                      _token_tiles(tokens.shape[1]),
                      _vectorized(tokens, weights), depth)


def grid_for(tokens: torch.Tensor, weights: torch.Tensor, depth: int) -> int:
    """The grid `gmm` launches for these CUDA tensors at `depth`:
    `grid_blocks` of their output tiles on `sm_count x blocks_per_sm`."""
    e, c, _ = tokens.shape
    tiles = e * -(-weights.shape[2] // F_TILE) * -(-c // (16 * _token_tiles(c)))
    capacity = ring.sm_count(tokens.device) * blocks_per_sm(tokens, weights,
                                                            depth)
    return grid_blocks(tiles, capacity)


def gmm_at(tokens: torch.Tensor, weights: torch.Tensor, *, depth: int,
           blocks: int) -> torch.Tensor:
    """`gmm` on CUDA tensors with `depth` k-slices in flight per block and
    a grid of `blocks` blocks (at most one per output tile; no solve, no
    record). The kernel's launch count is `gmm.launches`."""
    _check(tokens, weights)
    if tokens.device.type != "cuda":
        raise ValueError("gmm_at takes CUDA tensors")
    _check_cuda(tokens, weights, F_TILE)
    if not 1 <= depth <= ring.MAX_DEPTH:
        raise ValueError(f"depth must be in [1, {ring.MAX_DEPTH}], got {depth}")
    return _launch(tokens, weights, depth, blocks)


def _launch(tokens: torch.Tensor, weights: torch.Tensor, depth: int,
            blocks: Optional[int]) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors, on a grid of
    `blocks` blocks (None: `grid_for`'s)."""
    e, c, dm = tokens.shape
    f = weights.shape[2]
    itemsize = tokens.element_size()
    out = torch.empty((e, c, f), dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    tile = (_slice_rows(itemsize), F_TILE)
    ring.check_smem(depth * slot_bytes(c, itemsize) + ALIGN_SLACK,
                    kernel="moe_gmm", depth=depth, tile=tile)
    if blocks is None:
        blocks = grid_for(tokens, weights, depth)
    w = walk(e, c, dm, f, itemsize, blocks)
    lib = _library()
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        err = lib.repro_moe_gmm(
            tokens.data_ptr(), weights.data_ptr(), out.data_ptr(), c, dm, f,
            tokens.stride(0), tokens.stride(1), depth,
            ring.DTYPE_CODE[tokens.dtype], _token_tiles(c),
            int(_vectorized(tokens, weights)), w.blocks, w.tiles,
            w.per_tile, w.n_col, w.n_tok, stream)
    ring.raise_on_error(err, lib, kernel="moe_gmm", depth=depth, tile=tile)
    gmm.launches += 1
    return out


gmm.launches = 0
