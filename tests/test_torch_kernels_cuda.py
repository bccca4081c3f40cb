"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the reference package, so it also runs on
the GPU machine (``python -m pytest -q tests/test_torch_kernels_cuda.py``).
Without a CUDA device every test skips: a CUDA kernel has no CPU mode.
Tolerances: 2e-3 in f32, 3e-2 in bf16 (the reference's parity bounds);
the gathers are copies and must be bitwise; the triad takes the reference
test's 1e-5 (f32) and 2e-2 (bf16).
"""
import pytest
import torch

import repro_torch
from repro_torch.kernels import launch_counts
from repro_torch.kernels.coro_gather import coro_gather as cg
from repro_torch.kernels.coro_gather import ops as gather_ops
from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
from repro_torch.kernels.coro_scatter_add import ops as scatter_ops
from repro_torch.kernels.decode_attention import decode_attention as da
from repro_torch.kernels.stream_copy import stream_copy as sc
from repro_torch.launch.kernel_bench import coalesce_patterns

TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # the plain version's f32 products must not drop to TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, dtype, lengths, *, h, kh, d, blk, seed=0):
    """Random pools, disjoint shuffled block tables, and one zero-length
    padding row on the garbage page 0 (the last row)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    nb_per = [-(-n // blk) for n in lengths]
    m, total = max(nb_per), sum(nb_per)
    nb = total + 4
    q = torch.randn(len(lengths) + 1, h, d, generator=g)
    kp = torch.randn(nb, blk, kh, d, generator=g)
    vp = torch.randn(nb, blk, kh, d, generator=g)
    ids = torch.randperm(nb - 1, generator=g)[:total] + 1
    bt = torch.zeros(len(lengths) + 1, m, dtype=torch.int32)
    off = 0
    for r, n in enumerate(nb_per):
        bt[r, :n] = ids[off:off + n]
        off += n
    lens = torch.tensor(list(lengths) + [0], dtype=torch.int32)
    return (q.to(device, dtype), kp.to(device, dtype), vp.to(device, dtype),
            bt.to(device), lens.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,d", [(32, 4, 128), (32, 8, 64), (4, 2, 16),
                                    (48, 8, 128), (32, 1, 64)])
def test_kernel_matches_plain(cuda_device, dtype, h, kh, d):
    """Ragged lengths around page edges and past 2k, at depths 1, 2 and
    the solved one; the padding row is finite."""
    args = _problem(cuda_device, dtype, [1, 15, 16, 17, 300, 2048], h=h,
                    kh=kh, d=d, blk=16)
    ref = da.paged_flash_decode_plain(*args).float()
    for depth in (1, 2, None):
        out = da.paged_flash_decode(*args, depth=depth).float()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out[:-1], ref[:-1], rtol=TOL[dtype],
                                   atol=TOL[dtype])
    assert launch_counts()["paged_decode"] == 3


@pytest.mark.parametrize("blk", [4, 8, 32])
def test_kernel_page_sizes(cuda_device, blk):
    args = _problem(cuda_device, torch.float32, [3, 40, 129], h=8, kh=2, d=64,
                    blk=blk, seed=blk)
    out = da.paged_flash_decode(*args)
    ref = da.paged_flash_decode_plain(*args)
    torch.testing.assert_close(out[:-1], ref[:-1], rtol=2e-3, atol=2e-3)


def test_kernel_raises_instead_of_falling_back(cuda_device):
    q, kp, vp, bt, lens = _problem(cuda_device, torch.float32, [5, 9], h=4,
                                   kh=2, d=16, blk=8)
    with pytest.raises(TypeError):          # no f16 kernel
        da.paged_flash_decode(q.half(), kp.half(), vp.half(), bt, lens)
    with pytest.raises(ValueError):         # head_dim 32 not built
        da.paged_flash_decode(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                              vp[..., :8].contiguous(), bt, lens)
    with pytest.raises(ValueError):         # mixed devices
        da.paged_flash_decode(q, kp.cpu(), vp, bt, lens)
    strided = torch.cat([kp, kp], dim=-1)[..., ::2]
    assert strided.shape == kp.shape and not strided.is_contiguous()
    with pytest.raises(ValueError):         # non-contiguous pool
        da.paged_flash_decode(q, strided, vp, bt, lens)
    assert launch_counts()["paged_decode"] == 0


# ----------------------------------------------- GUPS-path kernels (K5-K7)


def _table(device, rows, d, dtype, seed=0, scale=10.0):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return (torch.randn(rows, d, generator=g) * scale).to(device, dtype)


def _ints(device, hi, n, seed=1):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return torch.randint(0, hi, (n,), generator=g, dtype=torch.int32).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint8])
@pytest.mark.parametrize("rows,d", [(300, 128), (128, 8), (64, 5), (64, 6)])
@pytest.mark.parametrize("rows_per_tile", [1, 4, 8])
def test_row_gather_bitwise(cuda_device, dtype, rows, d, rows_per_tile):
    """Rows of 16-byte units, of 4-byte words (d=5 or 6 in f32 and int32),
    of 2-byte units (bf16 d=5, uint8 d=6) and of bytes (uint8 d=5), at
    depths 1, 2 and solved: a copy is bitwise."""
    tab = _table(cuda_device, rows, d, dtype)
    idx = _ints(cuda_device, rows, 48)
    for depth in (1, 2, None):
        out = cg.row_gather(tab, idx, depth=depth, rows_per_tile=rows_per_tile)
        assert torch.equal(out, cg.row_gather_plain(tab, idx))
    assert launch_counts()["row_gather"] == 3


def test_deep_ring_bitwise(cuda_device):
    """Depths past 16, up to the deepest the kernels compile, keep every
    tile of a block in flight and still copy bitwise."""
    from repro_torch.kernels import ring

    tab = _table(cuda_device, 4096, 128, torch.float32)
    idx = _ints(cuda_device, 4096, 4096)
    for depth in (17, 40, ring.MAX_DEPTH):
        out = cg.row_gather(tab, idx, depth=depth, rows_per_tile=1)
        assert torch.equal(out, cg.row_gather_plain(tab, idx))
    assert launch_counts()["row_gather"] == 3


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 64),
                                     (torch.int32, 64), (torch.bfloat16, 5)])
def test_span_gather_and_ops_bitwise(cuda_device, dtype, d):
    tab = _table(cuda_device, 512, d, dtype)
    starts = _ints(cuda_device, 512 - 8, 21)
    for depth in (1, 2, None):
        assert torch.equal(cg.span_gather(tab, starts, span=8, depth=depth),
                           cg.span_gather_plain(tab, starts, 8))
    idx = _ints(cuda_device, 512, 61)             # off the 8-row tile
    assert torch.equal(gather_ops.coro_gather(tab, idx), tab[idx.long()])
    assert launch_counts()["span_gather"] == 3
    assert launch_counts()["row_gather"] == 1


@pytest.mark.parametrize("pattern", ["gups_random", "stream_unit", "hj_mixed"])
def test_coalesced_gather_bitwise(cuda_device, pattern):
    idx = coalesce_patterns()[pattern]
    tab = _table(cuda_device, 4096, 128, torch.float32)
    out, plan = gather_ops.coalesced_gather(tab, idx)
    assert torch.equal(out, tab[torch.as_tensor(idx, device=cuda_device)])
    assert launch_counts()["span_gather"] == int(plan.n_spans > 0)
    assert launch_counts()["row_gather"] == int(plan.n_singles > 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 3e-2)])
def test_scatter_add_with_duplicates(cuda_device, dtype, tol):
    # unit scale, as the reference test: the tolerance is bf16's at ~1
    tab = _table(cuda_device, 512, 64, dtype, scale=1.0)
    idx = _ints(cuda_device, 512, 300)           # many duplicates
    upd = _table(cuda_device, 300, 64, dtype, seed=3, scale=1.0)
    want = tab.to(torch.float32, copy=True).index_put_(
        (idx.long(),), upd.float(), accumulate=True)
    before = tab.clone()
    for depth in (1, 2, None):
        got = scatter_ops.coro_scatter_add(tab, idx, upd, depth=depth)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert torch.equal(tab, before)              # the op leaves its input
    assert launch_counts()["scatter_add"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 5])
def test_scatter_add_unique_bitwise(cuda_device, dtype, d):
    """One f32 add rounded once: the kernel equals its plain version (d=5
    is 2-byte units in bf16)."""
    tab = _table(cuda_device, 1024, d, dtype)
    uniq = torch.randperm(1024, device=cuda_device)[:400].int()
    upd = _table(cuda_device, 400, d, dtype, seed=4)
    want = sa.scatter_add_unique_plain(tab.clone(), uniq, upd)
    for depth in (1, 2, None):
        got = sa.scatter_add_unique(tab.clone(), uniq, upd, depth=depth)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d,rows", [(4096, 128, 128), (640, 96, 64),
                                      (64, 3, 2), (63, 3, 1)])
def test_triad_matches_plain(cuda_device, dtype, tol, n, d, rows):
    b = _table(cuda_device, n, d, dtype, seed=5)
    c = _table(cuda_device, n, d, dtype, seed=6)
    want = sc.triad_plain(b, c, 3.0)
    for depth in (1, 2, None):
        got = sc.triad(b, c, 3.0, rows=rows, depth=depth)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    assert launch_counts()["stream_triad"] == 3


def test_gups_kernels_raise_instead_of_falling_back(cuda_device):
    tab = _table(cuda_device, 64, 3, torch.bfloat16)
    idx = _ints(cuda_device, 64, 8)
    with pytest.raises(ValueError):                      # non-contiguous
        cg.row_gather(torch.cat([tab, tab], dim=1)[:, ::2], idx)
    with pytest.raises(ValueError):                      # mixed devices
        cg.row_gather(tab, idx.cpu())
    with pytest.raises(TypeError):                       # int64 indices
        cg.row_gather(_table(cuda_device, 64, 8, torch.float32), idx.long())
    f16 = _table(cuda_device, 64, 8, torch.float16)
    with pytest.raises(TypeError):                       # no f16 kernel
        sc.triad(f16, f16, 1.0, rows=8)
    assert sum(launch_counts().values()) == 0
