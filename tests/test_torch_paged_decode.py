"""Paged flash-decode in the PyTorch port against the JAX reference.

The port's plain version (what its wrapper runs on CPU tensors) is held to
the reference's Pallas kernel in interpret mode and to the reference's jnp
twin, on the same numpy inputs, at the reference tests' 2e-5 (f32). The
kernel's CoroSpec must give the same context bytes and the same solved
depth as the reference's under one shared MachineModel. The CUDA kernel
itself is checked against the plain version on the card
(`test_torch_kernels_cuda.py`).
"""
import ast
import dataclasses
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.kernels.decode_attention import decode_attention as ref_da
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as ref_paged_op
from repro.models import common as ref_common
from repro_torch.core import autotune, machine
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.decode_attention import decode_attention as da

TOL = 2e-5


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _problem(rng, lengths, *, h, kh, d, blk, extra_blocks=3):
    """Random pools + disjoint shuffled block tables (numpy, float32)."""
    lengths = np.asarray(lengths, np.int32)
    nb_per = [-(-int(n) // blk) for n in lengths]
    m = max(max(nb_per), 1)
    total = sum(nb_per)
    nb = total + 1 + extra_blocks
    q = rng.randn(len(lengths), h, d).astype(np.float32)
    kp = rng.randn(nb, blk, kh, d).astype(np.float32)
    vp = rng.randn(nb, blk, kh, d).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb))[:total]
    bt = np.zeros((len(lengths), m), np.int32)
    off = 0
    for r, n in enumerate(nb_per):
        bt[r, :n] = ids[off:off + n]
        off += n
    return q, kp, vp, bt, lengths


def _port(q, kp, vp, bt, lens, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, kp, vp, bt, lens)]
    return da.paged_flash_decode(*t, **kw).numpy()


def _twin(q, kp, vp, bt, lens):
    out = ref_common.paged_decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(lens))
    return np.asarray(out[:, 0])


def _pallas(q, kp, vp, bt, lens, depth=None):
    return np.asarray(ref_paged_op(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(bt),
                                   jnp.asarray(lens), depth=depth,
                                   interpret=True))


def test_plain_matches_pallas_and_twin_on_ragged_lengths():
    rng = np.random.RandomState(0)
    prob = _problem(rng, [16, 40, 128], h=8, kh=2, d=16, blk=16)
    out = _port(*prob)
    np.testing.assert_allclose(out, _pallas(*prob), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, _twin(*prob), rtol=TOL, atol=TOL)
    assert launch_counts()["paged_decode"] == 0   # CPU tensors: plain path


def test_plain_depths_and_zero_length_padding_row():
    """Depth sweep + a zero-length padding slot on the garbage page: real
    rows match the reference kernel, the padding row is finite."""
    rng = np.random.RandomState(1)
    q, kp, vp, bt, lens = _problem(rng, [32, 8, 0], h=4, kh=2, d=16, blk=8)
    bt[2] = 0
    ref = _twin(q, kp, vp, bt, lens)
    for depth in (1, 2, 5):
        out = _port(q, kp, vp, bt, lens, depth=depth)
        np.testing.assert_allclose(out[:2], ref[:2], rtol=TOL, atol=TOL)
        assert np.isfinite(out).all()
    pal = _pallas(q, kp, vp, bt, lens, depth=2)
    np.testing.assert_allclose(_port(q, kp, vp, bt, lens)[:2], pal[:2],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kh,h,blk", [(2, 8, 16), (1, 4, 32), (4, 4, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_ragged_sweep(kh, h, blk, seed):
    """Random length mixes with >= 4x spread, against the jnp twin (and the
    Pallas kernel for one case: each interpret-mode call costs seconds)."""
    rng = np.random.RandomState(100 + seed)
    base = int(rng.randint(1, 2 * blk))
    lengths = sorted(rng.randint(base, 8 * base + 1, size=4).tolist())
    lengths[0], lengths[-1] = base, max(lengths[-1], 4 * base)
    prob = _problem(rng, lengths, h=h, kh=kh, d=16, blk=blk)
    out = _port(*prob)
    np.testing.assert_allclose(out, _twin(*prob), rtol=TOL, atol=TOL)
    if seed == 0 and kh == 2:
        np.testing.assert_allclose(out, _pallas(*prob), rtol=TOL, atol=TOL)


def test_plain_keeps_bf16_and_masks_past_the_table():
    """Output keeps q's type; lengths past the table attend the whole
    table, as the reference's masked walk does."""
    rng = np.random.RandomState(3)
    q, kp, vp, bt, lens = _problem(rng, [20, 9], h=4, kh=2, d=16, blk=8)
    long = np.array([1000, 9], np.int32)
    out = _port(q, kp, vp, bt, long)
    np.testing.assert_allclose(out, _twin(q, kp, vp, bt, long), rtol=TOL,
                               atol=TOL)
    tq = torch.from_numpy(q).bfloat16()
    res = da.paged_flash_decode(tq, torch.from_numpy(kp).bfloat16(),
                                torch.from_numpy(vp).bfloat16(),
                                torch.from_numpy(bt), torch.from_numpy(lens))
    assert res.dtype == torch.bfloat16 and res.shape == tq.shape


def test_wrapper_rejects_bad_inputs():
    rng = np.random.RandomState(4)
    q, kp, vp, bt, lens = (torch.from_numpy(a) for a in
                           _problem(rng, [5, 9], h=4, kh=2, d=16, blk=8))
    with pytest.raises(ValueError):
        da.paged_flash_decode(q, kp, vp, bt, lens, depth=0)
    with pytest.raises(ValueError):
        da.paged_flash_decode(q[:, :3], kp, vp, bt, lens)   # H % KH != 0
    with pytest.raises(ValueError):
        da.paged_flash_decode(q, kp, vp, bt[:1], lens)
    with pytest.raises(ValueError):
        da.paged_flash_decode(q, kp, vp[:, :4], bt, lens)


def test_kernel_depth_clamps_to_shared_memory_and_tiles():
    """A depth in pages becomes ring tiles of the shared kernel's layout,
    and the depth recorded is the one that runs, in pages."""
    # yi-6b bf16, 16-row pages, 64-row tiles: 34816 B per padded K/V tile
    # pair, 128 table entries (512 B) beside them -> 6 tiles = 24 pages
    kw = dict(g=8, d=128, page=16, blk=64, itemsize=2, m=128)
    tiles = da.kernel_depth(64, n_tiles=100, **kw)
    assert tiles == 6 and da.ring_pages(tiles, 64, 16) == 24
    slots = da._table_slots(128, 16, 64, 100)
    assert da._flash_smem_bytes(8, 128, 64, 6, 2, slots) <= ring.SMEM_LIMIT
    assert da._flash_smem_bytes(8, 128, 64, 7, 2, slots) > ring.SMEM_LIMIT
    assert da.kernel_depth(64, n_tiles=1, **kw) == 1      # one split's tiles
    assert da.kernel_depth(5, n_tiles=100, **kw) == 1     # 80 rows: one tile
    assert da.kernel_depth(8, n_tiles=100, **kw) == 2
    with pytest.raises(ValueError):
        da.kernel_depth(0, n_tiles=10, **kw)
    # through the wrapper (CPU tensors: the plain version, the same record)
    rng = np.random.RandomState(2)
    prob = _problem(rng, [300, 40], h=8, kh=2, d=16, blk=16)
    _port(*prob, depth=12, blk=32)                  # 192 rows: 6 tiles of 32
    assert autotune.last_choice("paged_decode") == 12
    _port(*prob, depth=12, blk=32, splits=4)        # 19 pages: 4 splits of 3
    assert autotune.last_choice("paged_decode") == 6
    assert launch_counts()["paged_decode"] == 0


@pytest.mark.parametrize("depth", [16, 17, 27, 64, 65, 500])
@pytest.mark.parametrize("g,d,page,itemsize", [(8, 128, 16, 2), (1, 16, 4, 4),
                                               (2, 64, 8, 2)])
def test_kernel_depth_never_exceeds_max_depth(depth, g, d, page, itemsize):
    """The recorded depth is the depth that runs: the ring holds at most
    ring.MAX_DEPTH tiles (the deepest wait the shared ring header
    compiles), fits one block's shared memory beside its table slice under
    `_flash_smem_bytes`, and is cut only where one more tile would not
    fit; in pages it is tiles x blk / page."""
    blk, n_tiles = da.FLASH_BLK, 1000
    m = n_tiles * blk // page
    tiles = da.kernel_depth(depth, g=g, d=d, page=page, blk=blk,
                            itemsize=itemsize, n_tiles=n_tiles, m=m)
    slots = da._table_slots(m, page, blk, n_tiles)
    asked = max(1, depth * page // blk)
    assert 1 <= tiles <= min(asked, ring.MAX_DEPTH)
    assert da._flash_smem_bytes(g, d, blk, tiles, itemsize, slots) <= \
        ring.SMEM_LIMIT
    if tiles < min(asked, ring.MAX_DEPTH):
        assert da._flash_smem_bytes(g, d, blk, tiles + 1, itemsize, slots) \
            > ring.SMEM_LIMIT
    pages = da.ring_pages(tiles, blk, page)
    assert pages == tiles * blk // page <= depth


def test_kernel_source_uses_the_shared_ring():
    """K1 runs K3's split body: `paged_decode.cu` is gone, `flash_decode.cu`
    holds both row functions and one split kernel (and waits through
    coro_ring.cuh), and the wrapper never reads `lengths` or
    `block_tables` on the host: its grid comes from M x page."""
    csrc = Path(da.FLASH_SOURCE).parent
    assert not (csrc / "paged_decode.cu").exists()
    assert sorted(p.name for p in csrc.glob("*.cu")) == ["flash_decode.cu"]
    assert not hasattr(da, "SOURCE") and not hasattr(da, "HEAD_DIMS")
    src = Path(da.FLASH_SOURCE).read_text()
    assert '#include "../../csrc/coro_ring.cuh"' in src
    assert not re.search(r"void\s+cp_async_wait_pending", src)
    assert "struct DenseRows" in src and "struct PagedRows" in src
    assert len(re.findall(r"__global__ void", src)) == 2      # split + merge
    assert src.count("flash_split_kernel(") == 1              # one body
    assert "flash_split_kernel<T, D, GP, Rows>" in src
    assert 'extern "C" int repro_paged_flash_decode(' in src
    assert "lengths[b]" in src                                # on the device
    assert "repro_cuda_error_string" not in src               # the header's
    host = inspect.getsource(da.paged_flash_decode) + \
        inspect.getsource(da._check_paged)
    watched = {"lengths", "block_tables"}
    for node in ast.walk(ast.parse(host)):
        if isinstance(node, ast.Attribute) and \
                getattr(node.value, "id", None) in watched:
            assert node.attr in ("data_ptr", "shape", "dtype", "dim"), \
                ast.unparse(node)
        if isinstance(node, ast.Subscript):
            assert getattr(node.value, "id", None) not in watched, \
                ast.unparse(node)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id in ("paged_flash_decode_plain", "_check_paged") \
                or not watched & {getattr(a, "id", None) for a in node.args}, \
                ast.unparse(node)
    assert "split_plan(b, kh, m * page, blk" in host


# --------------------------------------------- the kernel's split and merge


H100_SMS = 132
# table widths whose rows (M x page) are not a multiple of the 64-row tile
TABLE_WIDTH = {4: 73, 8: 37, 16: 19, 32: 9}


def _paged_table(rng, lengths, m, *, h, kh, d, page):
    """Random pools and a [B, M] table: each request's pages distinct and
    shuffled, the rest of its row the garbage page 0."""
    need = [min(-(-max(n, 0) // page), m) for n in lengths]
    nb = sum(need) + 3
    q = rng.randn(len(lengths), h, d).astype(np.float32)
    kp = rng.randn(nb, page, kh, d).astype(np.float32)
    vp = rng.randn(nb, page, kh, d).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb))
    bt = np.zeros((len(lengths), m), np.int32)
    off = 0
    for r, n in enumerate(need):
        bt[r, :n] = ids[off:off + n]
        off += n
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _paged_split_merge_model(q, kp, vp, bt, lens, blk, n_split, per):
    """The kernel's arithmetic in torch ops: request b's live rows are
    min(lengths[b], M x page); split i's rows [i per blk, (i+1) per blk)
    below that are read through the block's table slice (entries from
    row0 / page on, `_table_slots` of them, clamped to the last), giving
    an f32 partial (m in the log2 domain, l, acc), an empty partial
    (-1e30, 0, 0) past the live rows; then the merge kernel's formula."""
    b, h, d = q.shape
    page, kh = kp.shape[1], kp.shape[2]
    m = bt.shape[1]
    g = h // kh
    slots = da._table_slots(m, page, blk, per)
    scale_log2 = d ** -0.5 * 1.4426950408889634
    out = torch.empty(b, kh, g, d)
    for r in range(b):
        n_keys = max(0, min(int(lens[r]), m * page))
        ms, ls, accs = [], [], []
        qg = q[r].float().reshape(kh, g, d)
        for i in range(n_split):
            row0 = i * per * blk
            hi = min(n_keys, row0 + per * blk)
            if hi <= row0:
                ms.append(torch.full((kh, g), da.NEG_INF))
                ls.append(torch.zeros(kh, g))
                accs.append(torch.zeros(kh, g, d))
                continue
            p0 = row0 // page
            table = bt[r, [min(p0 + j, m - 1) for j in range(slots)]]
            rows = torch.arange(row0, hi)
            slot = rows // page - p0
            assert int(slot.max()) < slots
            k = kp[table[slot].long(), rows % page].float()     # [n, kh, d]
            v = vp[table[slot].long(), rows % page].float()
            sc = torch.einsum("kgd,nkd->kgn", qg, k) * scale_log2
            mx = sc.amax(dim=-1)
            p = torch.exp2(sc - mx[..., None])
            ms.append(mx)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("kgn,nkd->kgd", p, v))
        m_all = torch.stack(ms)
        mx = m_all.amax(dim=0)
        w = torch.exp2(m_all - mx)
        l_all = (torch.stack(ls) * w).sum(dim=0)
        acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
        out[r] = acc / l_all.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


@pytest.mark.parametrize("blk,splits", [(64, 1), (64, 2), (64, None),
                                        (32, 3), (32, None)])
@pytest.mark.parametrize("page", [4, 8, 16, 32])
def test_paged_split_and_merge_equal_the_plain_version(page, blk, splits):
    """Ragged lengths, a length of 0, lengths at the run's first split
    boundary +-1, the whole table and past it, over pages of 4-32 rows in
    a table whose M x page is off the 64-row tile, merged as the kernel
    merges, against the plain version (and the reference's Pallas kernel
    in interpret mode, once per page size) at 2e-5 in f32; the
    zero-length row comes out 0."""
    m = TABLE_WIDTH[page]
    n_split, per = da.split_plan(8, 2, m * page, blk, H100_SMS, splits)
    assert n_split * per * blk >= m * page
    edge = min(per * blk, m * page - 1)
    rng = np.random.RandomState(page * 100 + blk + (splits or 0))
    lengths = [0, edge - 1, edge, edge + 1, 1, 37, m * page, m * page + 50]
    prob = _paged_table(rng, lengths, m, h=8, kh=2, d=16, page=page)
    t = [torch.from_numpy(a) for a in prob]
    got = _paged_split_merge_model(*t, blk, n_split, per).numpy()
    assert np.isfinite(got).all() and not got[0].any()    # length 0: zeros
    np.testing.assert_allclose(got[1:],
                               da.paged_flash_decode_plain(*t).numpy()[1:],
                               rtol=TOL, atol=TOL)
    if splits is None and blk == 64:
        np.testing.assert_allclose(got[1:], _pallas(*prob)[1:], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("profile", ["v5e", "cpu-interpret", "h100"])
@pytest.mark.parametrize("blk,kh,g,d,dtype", [
    (16, 4, 8, 128, "bfloat16"),     # yi-6b
    (16, 8, 4, 64, "bfloat16"),      # granite-3-2b
    (16, 2, 2, 16, "float32"),       # reduced yi-6b
])
def test_spec_context_and_depth_match_reference(profile, blk, kh, g, d, dtype):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    spec = da.paged_decode_spec(blk, kh, g, d, getattr(torch, dtype),
                                max_blocks=64)
    ref_spec = ref_da.paged_decode_spec(blk, kh, g, d, jnp.dtype(dtype),
                                        max_blocks=64)
    for depth in (1, 2, 7):
        assert spec.context_bytes(depth) == ref_spec.context_bytes(depth)
        assert spec.context_bytes(depth, baseline=True) == \
            ref_spec.context_bytes(depth, baseline=True)
    assert spec.profile() == type(spec.profile())(
        **dataclasses.asdict(ref_spec.profile()))
    got = autotune.choose_depth(spec.profile(), machine=mm,
                                vars=spec.all_vars())
    want = ref_autotune.choose_depth(ref_spec.profile(), machine=ref_mm,
                                     vars=ref_spec.all_vars())
    assert got == want
