"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the reference package, so it also runs on
the GPU machine (``python -m pytest -q tests/test_torch_kernels_cuda.py``).
Without a CUDA device every test skips: a CUDA kernel has no CPU mode.
Tolerances: 2e-3 in f32, 3e-2 in bf16 (the reference's parity bounds;
in bf16 3e-2 + 3e-2 x |value| for the grouped matmul, whose sums run in
another order than the plain version's); decode attention, whose outputs
over randn K/V are ~0.05, is held tighter: 2e-4 in f32, 3e-3 + 1e-2 x
|value| in bf16 (one bf16 rounding step of the output is at most 2^-7 of
it);
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
DECODE_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-4),
              torch.bfloat16: dict(atol=3e-3, rtol=1e-2)}


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
        torch.testing.assert_close(out[:-1], ref[:-1], **DECODE_TOL[dtype])
    assert launch_counts()["paged_decode"] == 3


@pytest.mark.parametrize("blk", [4, 8, 32])
def test_kernel_page_sizes(cuda_device, blk):
    args = _problem(cuda_device, torch.float32, [3, 40, 129], h=8, kh=2, d=64,
                    blk=blk, seed=blk)
    out = da.paged_flash_decode(*args)
    ref = da.paged_flash_decode_plain(*args)
    torch.testing.assert_close(out[:-1], ref[:-1],
                               **DECODE_TOL[torch.float32])


def test_kernel_raises_instead_of_falling_back(cuda_device):
    q, kp, vp, bt, lens = _problem(cuda_device, torch.float32, [5, 9], h=4,
                                   kh=2, d=16, blk=8)
    with pytest.raises(TypeError):          # no f16 kernel
        da.paged_flash_decode(q.half(), kp.half(), vp.half(), bt, lens)
    with pytest.raises(ValueError):         # head_dim 8 not built
        da.paged_flash_decode(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                              vp[..., :8].contiguous(), bt, lens)
    with pytest.raises(ValueError):         # mixed devices
        da.paged_flash_decode(q, kp.cpu(), vp, bt, lens)
    strided = torch.cat([kp, kp], dim=-1)[..., ::2]
    assert strided.shape == kp.shape and not strided.is_contiguous()
    with pytest.raises(ValueError):         # non-contiguous pool
        da.paged_flash_decode(q, strided, vp, bt, lens)
    with pytest.raises(ValueError):         # a tile not in 16-row chunks
        da.paged_flash_decode(q, kp, vp, bt, lens, blk=24)
    with pytest.raises(TypeError):          # int64 lengths
        da.paged_flash_decode(q, kp, vp, bt, lens.long())
    assert launch_counts()["paged_decode"] == 0


@pytest.mark.parametrize("depth", [17, 20, 27])
def test_kernel_deep_ring(cuda_device, depth):
    """Deep page depths become rings of the shared layout's 64-row tiles:
    one split of 32 tiles takes 4, 5 and 6 tiles (6 is also all that one
    block's shared memory holds), the plan's splits of 2 tiles take 2; the
    depth recorded, in pages, is the clamp's, and the output agrees with
    the plain version."""
    from repro_torch.core import autotune

    args = _problem(cuda_device, torch.bfloat16, [300, 517, 2048], h=32, kh=4,
                    d=128, blk=16, seed=depth)
    ref = da.paged_flash_decode_plain(*args)
    m = args[3].shape[1]
    for splits in (1, None):
        _, per = da.split_plan(4, 4, m * 16, da.FLASH_BLK, _sms(cuda_device),
                               splits)
        tiles = da.kernel_depth(depth, g=8, d=128, page=16, blk=da.FLASH_BLK,
                                itemsize=2, n_tiles=per, m=m)
        out = da.paged_flash_decode(*args, depth=depth, splits=splits)
        assert autotune.last_choice("paged_decode") == \
            da.ring_pages(tiles, da.FLASH_BLK, 16)
        assert tiles == (min(depth // 4, 6) if splits == 1 else per)
        torch.testing.assert_close(out[:-1].float(), ref[:-1].float(),
                                   **DECODE_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blk", [32, 64])
@pytest.mark.parametrize("splits", [1, 2, None])
def test_kernel_splits_and_tiles(cuda_device, dtype, splits, blk):
    """yi-6b's heads over a 19-page table (304 rows, off the tile) at
    B 8: one split, two and the plan's, lengths at the run's first split
    boundary +-1 (inside the table), in the first split and the whole
    table; the zero-length row is 0."""
    n_split, per = da.split_plan(8, 4, 19 * 16, blk, _sms(cuda_device), splits)
    edge = per * blk
    lengths = [1, 37, 200, 304] + [min(n, 303) for n in (edge - 1, edge,
                                                         edge + 1)]
    args = _problem(cuda_device, dtype, lengths, h=32, kh=4, d=128, blk=16,
                    seed=blk + (splits or 0))
    assert args[3].shape[1] == 19 and n_split == (splits or n_split)
    out = da.paged_flash_decode(*args, blk=blk, splits=splits).float()
    ref = da.paged_flash_decode_plain(*args).float()
    assert torch.isfinite(out).all() and not out[-1].any()
    torch.testing.assert_close(out[:-1], ref[:-1], **DECODE_TOL[dtype])
    assert launch_counts()["paged_decode"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 6, 8, 32])
def test_kernel_groups_and_head_dims(cuda_device, dtype, d, g):
    """Every group size (G <= 16 is one M tile in bf16, 32 two) and head
    dim, over 8-row pages, at the plan's splits."""
    args = _problem(cuda_device, dtype, [17, 96, 290], h=2 * g, kh=2, d=d,
                    blk=8, seed=g * d)
    out = da.paged_flash_decode(*args).float()
    torch.testing.assert_close(out[:-1],
                               da.paged_flash_decode_plain(*args)[:-1].float(),
                               **DECODE_TOL[dtype])
    assert torch.isfinite(out).all()
    assert launch_counts()["paged_decode"] == 1


@pytest.mark.parametrize("splits", [1, None])
def test_kernel_zero_length_rows(cuda_device, splits):
    """Round padding: a batch where every length is 0 (every partial
    empty) and one where some are, both in one split and in many; the
    padding rows come out 0, the others agree with the plain version."""
    for lengths in ([0, 0, 0], [0, 40, 0, 129]):
        q, kp, vp, bt, lens = _problem(cuda_device, torch.bfloat16,
                                       [max(n, 1) for n in lengths], h=8,
                                       kh=2, d=64, blk=16, seed=len(lengths))
        lens = torch.tensor(lengths + [0], dtype=torch.int32,
                            device=cuda_device)
        out = da.paged_flash_decode(q, kp, vp, bt, lens,
                                    splits=splits).float()
        ref = da.paged_flash_decode_plain(q, kp, vp, bt, lens).float()
        live = lens > 0
        assert torch.isfinite(out).all() and not out[~live].any()
        torch.testing.assert_close(out[live], ref[live],
                                   **DECODE_TOL[torch.bfloat16])


@pytest.mark.parametrize("page", [4, 16, 64])
def test_kernel_table_of_width_one(cuda_device, page):
    """M = 1: one page per request, lengths inside it, filling it and past
    it (the whole page)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(page)
    q = torch.randn(4, 8, 64, generator=g).to(cuda_device)
    kp, vp = (torch.randn(5, page, 2, 64, generator=g).to(cuda_device)
              for _ in range(2))
    bt = torch.tensor([[3], [1], [4], [2]], dtype=torch.int32,
                      device=cuda_device)
    lens = torch.tensor([1, page // 2, page, page + 9], dtype=torch.int32,
                        device=cuda_device)
    for splits in (1, None):
        out = da.paged_flash_decode(q, kp, vp, bt, lens, splits=splits)
        torch.testing.assert_close(
            out, da.paged_flash_decode_plain(q, kp, vp, bt, lens),
            **DECODE_TOL[torch.float32])


# ------------------------------------------- MoE grouped matmul (K2)


def _gmm_problem(device, dtype, e, c, dm, f, *, shared=False, seed=0):
    """Tokens [E, C, dm] (one block expanded over the experts when
    `shared`, a stride-0 view) and weights [E, dm, f] scaled by dm**-0.5."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    if shared:
        tokens = torch.randn(1, c, dm, generator=g).to(device, dtype)
        tokens = tokens.expand(e, c, dm)
    else:
        tokens = torch.randn(e, c, dm, generator=g).to(device, dtype)
    w = (torch.randn(e, dm, f, generator=g) * dm ** -0.5).to(device, dtype)
    return tokens, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,dm,f,shared", [
    (8, 5, 2048, 768, True),         # qwen3-moe decode round, gate / up
    (8, 5, 768, 2048, False),        # ... down projection
    (4, 32, 2048, 768, True),        # ... a prefill chunk
    (3, 1, 64, 32, True),            # reduced configs, one token
    (3, 5, 64, 32, False),
    (2, 33, 200, 136, False),        # ragged C, dm and f
    (2, 7, 50, 36, True),            # rows off the 16-byte unit
])
def test_gmm_matches_plain(cuda_device, dtype, e, c, dm, f, shared):
    """Depths 1, 2, the solved one and the largest that fits one block."""
    from repro_torch.core import autotune
    from repro_torch.kernels import ring
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    tokens, w = _gmm_problem(cuda_device, dtype, e, c, dm, f, shared=shared)
    ref = mg.gmm_plain(tokens, w).float()
    deepest = mg.kernel_depth(ring.MAX_DEPTH, c=c, dm=dm,
                              itemsize=tokens.element_size())
    for depth in (1, 2, None, deepest):
        out = mg.gmm(tokens, w, depth=depth)
        torch.cuda.synchronize()
        assert out.shape == (e, c, f) and out.dtype == dtype
        if depth is not None:           # the depth recorded is the one run
            assert autotune.last_choice("moe_gmm") == mg.kernel_depth(
                depth, c=c, dm=dm, itemsize=tokens.element_size())
        torch.testing.assert_close(out.float(), ref, rtol=TOL[dtype],
                                   atol=TOL[dtype])
    assert launch_counts()["moe_gmm"] == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,dm,f,shared,blocks", [
    (1, 5, 2048, 384, True, 2),      # three tiles over 2 blocks
    (3, 5, 2048, 128, True, 2),      # ... over 2 blocks, one per expert
    (2, 5, 64, 32, False, 1000),     # fewer tiles than blocks
    (1, 16, 512, 256, False, 5),     # one expert, C 16
    (3, 5, 200, 136, True, 7),       # ragged f and dm
    (3, 17, 256, 136, True, 4),      # C 17: two token tiles of 16
    (4, 32, 256, 384, False, 9),     # C 32: one token tile of 32
    (4, 5, 768, 512, False, None),   # the grid the wrapper picks
])
def test_gmm_persistent_walk(cuda_device, dtype, e, c, dm, f, shared, blocks):
    """Whole tiles dealt to a given grid in turn, some blocks walking one
    tile more than others: two calls in a row on one stream (different
    inputs) both agree with the plain version, and the same call twice
    gives the same bits."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    for seed in (0, 1):
        tokens, w = _gmm_problem(cuda_device, dtype, e, c, dm, f,
                                 shared=shared, seed=seed)
        run = (lambda: mg.gmm(tokens, w)) if blocks is None else \
            (lambda: mg.gmm_at(tokens, w, depth=2, blocks=blocks))
        out = run()
        again = run()
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), mg.gmm_plain(tokens, w).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert torch.equal(out, again)
    assert launch_counts()["moe_gmm"] == 4


def test_gmm_grid_fills_every_sm(cuda_device):
    """At qwen3-moe's gate/up shape the wrapper's grid walks two tiles a
    block (768 tiles, fewer than two waves of what fits the card at once),
    at least half of what fits, and its blocks hold at least 48 KiB of
    weight slices an SM in flight."""
    from repro_torch.kernels import ring
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    tokens, w = _gmm_problem(cuda_device, torch.bfloat16, 128, 5, 2048, 768,
                             shared=True)
    per_sm = mg.blocks_per_sm(tokens, w, 2)
    sm = ring.sm_count(cuda_device)
    grid = mg.grid_for(tokens, w, 2)
    assert per_sm >= 2 and sm * per_sm >= grid >= sm * per_sm / 2
    assert grid == mg.grid_blocks(768, sm * per_sm)
    assert grid * 2 * 64 * 128 * 2 >= sm * 48 * 1024


def test_moe_layer_runs_the_kernel(cuda_device):
    """A reduced MoE layer on the card: three grouped matmuls launch, and
    the layer agrees with the same layer on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import initialize

    cfg = get_config("qwen3-moe-30b-a3b").reduced().replace(
        dtype="float32", param_dtype="float32")
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    p = initialize(moe.moe_param_specs(cfg), g, "cpu")
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    want, _ = moe.moe_dense(p, x, cfg)
    assert launch_counts()["moe_gmm"] == 0
    got, _ = moe.moe_dense({k: v.to(cuda_device) for k, v in p.items()},
                           x.to(cuda_device), cfg)
    assert launch_counts()["moe_gmm"] == 3
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)


def test_gmm_raises_instead_of_falling_back(cuda_device):
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    tokens, w = _gmm_problem(cuda_device, torch.float32, 2, 4, 64, 32)
    with pytest.raises(TypeError):                       # no f16 kernel
        mg.gmm(tokens.half(), w.half())
    with pytest.raises(TypeError):                       # mixed types
        mg.gmm(tokens, w.bfloat16())
    with pytest.raises(ValueError):                      # another column tile
        mg.gmm(tokens, w, f_tile=64)
    with pytest.raises(ValueError):                      # mixed devices
        mg.gmm(tokens, w.cpu())
    with pytest.raises(ValueError):                      # strided weights
        mg.gmm(tokens, torch.cat([w, w], dim=-1)[..., ::2])
    with pytest.raises(ValueError):                      # strided columns
        mg.gmm(torch.cat([tokens, tokens], dim=-1)[..., ::2], w)
    assert launch_counts()["moe_gmm"] == 0


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("split", [None, (4, 14), (6, 9), (8, 6), (12, 4),
                                   (1, 56)])
def test_row_gather_per_sm_splits_bitwise(cuda_device, dtype, split):
    """The row gather at the solved per-SM split and at the splits the
    chip_smoke sweep times (blocks per SM x slots), over 2^15 ids of a
    4096-row table: bitwise."""
    tab = _table(cuda_device, 4096, 128, dtype)
    idx = _ints(cuda_device, 4096, 1 << 15)
    out = cg.row_gather(tab, idx) if split is None else cg.row_gather_at(
        tab, idx, blocks_per_sm=split[0], slots=split[1])
    assert torch.equal(out, cg.row_gather_plain(tab, idx))
    assert launch_counts()["row_gather"] == 1


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


# K6 at the solved split and at the per-SM splits chip_smoke sweeps (blocks
# per SM, slots a block)
K6_SPLITS = [None, (2, 14), (3, 8), (4, 7), (6, 4), (12, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 5])
@pytest.mark.parametrize("n", [8 * 4099, 40])
@pytest.mark.parametrize("split", K6_SPLITS)
def test_scatter_add_per_sm_splits_bitwise(cuda_device, dtype, d, n, split):
    """4099 tiles (off every split's block boundary) and 5 tiles (fewer
    than the blocks of any split) into a 2^16-row table, rows of 16-byte
    units and of 4- or (bf16) 2-byte units: bitwise, one launch a call."""
    tab = _table(cuda_device, 1 << 16, d, dtype)
    uniq = torch.randperm(1 << 16, device=cuda_device)[:n].int()
    upd = _table(cuda_device, n, d, dtype, seed=11)
    want = sa.scatter_add_unique_plain(tab.clone(), uniq, upd)
    got = sa.scatter_add_unique(tab.clone(), uniq, upd) if split is None \
        else sa.scatter_add_at(tab.clone(), uniq, upd,
                               blocks_per_sm=split[0], slots=split[1])
    assert torch.equal(got, want)
    assert launch_counts()["scatter_add"] == 1


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
    if dtype == torch.float32:
        assert torch.equal(sc.triad(b, c, 3.0, rows=rows), want)


# (n, d, rows, item_rows): items smaller than the caller's tile, fewer
# items than the card's SMs, an odd item count, 1 KiB to 16 KiB items
TRIAD_ITEMS = [(4096, 128, 128, 8), (4096, 128, 128, 2), (256, 128, 128, 8),
               (301 * 16, 64, 16, 16), (640, 96, 64, 16),
               (1 << 16, 128, 128, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,rows,item", TRIAD_ITEMS)
def test_triad_items(cuda_device, dtype, n, d, rows, item):
    b = _table(cuda_device, n, d, dtype, seed=7)
    c = _table(cuda_device, n, d, dtype, seed=8)
    got = sc.triad_at(b, c, 3.0, rows=rows, item_rows=item)
    want = sc.triad_plain(b, c, 3.0)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    assert launch_counts()["stream_triad"] == 1


@pytest.mark.parametrize("dtype,n,d,rows", [
    (torch.float32, 64, 3, 2), (torch.float32, 63, 3, 1),     # 4-byte units
    (torch.bfloat16, 64, 3, 2), (torch.bfloat16, 63, 3, 1),   # 4, 2 bytes
    (torch.float32, 257, 33, 16)])          # 16-byte items, a view 132 B in
def test_triad_unit_path(cuda_device, dtype, n, d, rows):
    b = _table(cuda_device, n, d, dtype, seed=9)
    c = _table(cuda_device, n, d, dtype, seed=10)
    if n % rows:                                  # a view one row in
        b, c = b[1:], c[1:]
    got = sc.triad(b, c, 2.5, rows=rows)
    want = sc.triad_plain(b, c, 2.5)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    assert launch_counts()["stream_triad"] == 1


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


# ------------------------------------------------- dense flash-decode (K3)


def _dense_problem(device, dtype, b, h, kh, d, s, seed=0):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    q = torch.randn(b, h, d, generator=g)
    k = torch.randn(b, s, kh, d, generator=g)
    v = torch.randn(b, s, kh, d, generator=g)
    return q.to(device, dtype), k.to(device, dtype), v.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,d,s", [(32, 4, 128, 1056), (32, 1, 64, 200),
                                      (8, 2, 16, 77), (8, 8, 32, 300)])
def test_flash_decode_matches_plain(cuda_device, dtype, h, kh, d, s):
    """S off the 128-row tile, pos 0, mid and last, one KV head; depths 1,
    2 and the solved one, each recorded as run."""
    from repro_torch.core import autotune

    q, k, v = _dense_problem(cuda_device, dtype, 3, h, kh, d, s, seed=s)
    for pos in (0, s // 2, s - 1):
        ref = da.flash_decode_plain(q, k, v, pos).float()
        for depth in (1, 2, None):
            out = da.flash_decode(q, k, v, pos, depth=depth)
            torch.cuda.synchronize()
            ran = autotune.last_choice("flash_decode")
            blk = da.FLASH_BLK
            _, per = da.split_plan(3, kh, s, blk, _sms(cuda_device))
            want = da.flash_kernel_depth(
                depth or ran, g=h // kh, d=d, blk=blk,
                itemsize=q.element_size(),
                n_tiles=min(per, -(-(pos + 1) // blk)))
            assert ran == want
            assert out.dtype == dtype and torch.isfinite(out.float()).all()
            torch.testing.assert_close(out.float(), ref,
                                       **DECODE_TOL[dtype])
    assert launch_counts()["flash_decode"] == 9


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blk", [64, 128])
@pytest.mark.parametrize("splits", [1, 2, None])
def test_flash_decode_splits(cuda_device, dtype, splits, blk):
    """yi-6b's heads over S 1056 at B 3, in 64- and 128-row tiles: one
    split, two and the plan's; pos in the first split (the later splits
    empty), at a boundary of the run's splits +-1, and past S."""
    q, k, v = _dense_problem(cuda_device, dtype, 3, 32, 4, 128, 1056, seed=7)
    n_split, per = da.split_plan(3, 4, 1056, blk, _sms(cuda_device), splits)
    assert n_split == (splits or n_split) and n_split * per * blk >= 1056
    edge = per * blk                         # the first split boundary
    positions = (0, 30, edge - 1, edge, edge + 1, 1040, 1055, 1500)
    for pos in positions:
        out = da.flash_decode(q, k, v, pos, blk=blk, splits=splits)
        torch.testing.assert_close(
            out.float(), da.flash_decode_plain(q, k, v, pos).float(),
            **DECODE_TOL[dtype])
    assert launch_counts()["flash_decode"] == len(positions)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 6, 8, 32])
def test_flash_decode_groups_and_head_dims(cuda_device, dtype, d, g):
    """Every group size (G <= 16 is one M tile in bf16, 32 two) and head
    dim, S 300 with a 44-row tail in 64-row tiles, pos inside the first
    and the last tile, the plan's splits (5 tiles: 5 splits at B 2)."""
    q, k, v = _dense_problem(cuda_device, dtype, 2, 2 * g, 2, d, 300,
                             seed=g * d)
    for pos in (17, 290):
        out = da.flash_decode(q, k, v, pos)
        torch.testing.assert_close(
            out.float(), da.flash_decode_plain(q, k, v, pos).float(),
            **DECODE_TOL[dtype])
    assert launch_counts()["flash_decode"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh", [1, 2])
@pytest.mark.parametrize("g", [1, 8, 16])
def test_flash_decode_head_dim_256(cuda_device, dtype, kh, g):
    """Head dim 256 (paligemma-3b: 8 heads on one KV head), G 1, 8 and 16,
    S 77 and 1056 (off the 64-row tile), pos 0, mid, last and past S;
    depths 1, 2 and solved, clamped to the K/V tile pairs one block's
    shared memory holds (3 in bf16, 1 in f32)."""
    from repro_torch.core import autotune

    fit = 3 if dtype == torch.bfloat16 else 1
    for s in (77, 1056):
        q, k, v = _dense_problem(cuda_device, dtype, 2, kh * g, kh, 256, s,
                                 seed=g + s)
        for pos in (0, s // 2, s - 1, s + 5):
            ref = da.flash_decode_plain(q, k, v, pos).float()
            for depth in (1, 2, None):
                out = da.flash_decode(q, k, v, pos, depth=depth)
                assert autotune.last_choice("flash_decode") <= fit
                torch.testing.assert_close(out.float(), ref,
                                           **DECODE_TOL[dtype])
    assert launch_counts()["flash_decode"] == 24


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, None])
def test_flash_decode_head_dim_256_splits(cuda_device, dtype, splits):
    """paligemma-3b's dense decode shape (B 8, H 8, KH 1, D 256, S 1056):
    one split, two and the plan's, pos at a split boundary +-1."""
    q, k, v = _dense_problem(cuda_device, dtype, 8, 8, 1, 256, 1056, seed=5)
    _, per = da.split_plan(8, 1, 1056, da.FLASH_BLK, _sms(cuda_device),
                           splits)
    edge = per * da.FLASH_BLK
    for pos in (edge - 1, edge, edge + 1, 1040):
        torch.testing.assert_close(
            da.flash_decode(q, k, v, pos, splits=splits).float(),
            da.flash_decode_plain(q, k, v, pos).float(), **DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_decode_runs_the_kernel_across_the_wrap(cuda_device, dtype):
    """The sliding-window ring decode (hymba-1.5b's heads: 25 on 5 KV
    heads, D 64) over 2w steps from an empty ring of w = 96 slots, pos on
    the device: each step's output against the plain version over the
    slots written so far, then over the whole ring after the wrap."""
    from repro_torch.models import lm

    w, b = 96, 2
    q, k, v = _dense_problem(cuda_device, dtype, b, 25, 5, 64, 2 * w, seed=4)
    kc = torch.zeros(b, w, 5, 64, dtype=dtype, device=cuda_device)
    vc = torch.zeros_like(kc)
    for pos in range(2 * w):
        dev_pos = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
        out, ok, ov = lm.ring_decode_attention(
            q[:, None], kc, vc, k[:, pos:pos + 1], v[:, pos:pos + 1],
            dev_pos, w)
        assert ok is kc and ov is vc
        assert torch.equal(kc[:, pos % w], k[:, pos])
        want = da.flash_decode_plain(q, kc, vc, min(pos, w - 1))
        torch.testing.assert_close(out[:, 0].float(), want.float(),
                                   **DECODE_TOL[dtype])
    assert launch_counts()["flash_decode"] == 2 * w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_one_split_when_the_batch_fills_the_card(cuda_device,
                                                              dtype):
    """B * KH >= 2 blocks per SM: the plan takes one split, and the split
    pass writes the output itself (no partials, no merge)."""
    sms = _sms(cuda_device)
    b, kh = da.BLOCKS_PER_SM * sms, 1
    assert da.split_plan(b, kh, 200, da.FLASH_BLK, sms) == (1, 4)
    q, k, v = _dense_problem(cuda_device, dtype, b, 4, kh, 64, 200, seed=3)
    out = da.flash_decode(q, k, v, 150)
    torch.testing.assert_close(
        out.float(), da.flash_decode_plain(q, k, v, 150).float(),
        **DECODE_TOL[dtype])
    assert launch_counts()["flash_decode"] == 1


def test_flash_decode_small_tiles_and_past_the_cache(cuda_device):
    """blk 32 with S = 100 (a 4-row tail), and pos past S (every key)."""
    q, k, v = _dense_problem(cuda_device, torch.float32, 2, 8, 2, 64, 100)
    for pos in (31, 32, 99, 150):
        out = da.flash_decode(q, k, v, pos, blk=32, depth=3)
        torch.testing.assert_close(out, da.flash_decode_plain(q, k, v, pos),
                                   **DECODE_TOL[torch.float32])


def test_dense_decode_step_writes_in_place_and_runs_the_kernel(cuda_device):
    from repro_torch.models import common

    q, k, v = _dense_problem(cuda_device, torch.bfloat16, 2, 8, 2, 64, 40)
    nk, nv = (t[:, :1].clone() for t in _dense_problem(
        cuda_device, torch.bfloat16, 2, 2, 2, 64, 1, seed=9)[1:])
    kc, vc = k.clone(), v.clone()
    out, ok, ov = common.decode_attention(q[:, None], kc, vc, nk, nv, 17)
    assert ok is kc and ov is vc
    assert torch.equal(kc[:, 17], nk[:, 0]) and torch.equal(vc[:, 18:], v[:, 18:])
    ref = da.flash_decode_plain(q, kc, vc, 17)
    torch.testing.assert_close(out[:, 0].float(), ref.float(),
                               **DECODE_TOL[torch.bfloat16])
    assert launch_counts()["flash_decode"] == 1


def test_flash_decode_raises_instead_of_falling_back(cuda_device):
    q, k, v = _dense_problem(cuda_device, torch.float32, 2, 4, 2, 16, 64)
    with pytest.raises(TypeError):          # no f16 kernel
        da.flash_decode(q.half(), k.half(), v.half(), 3)
    with pytest.raises(ValueError):         # head_dim 8 not built
        da.flash_decode(q[..., :8].contiguous(), k[..., :8].contiguous(),
                        v[..., :8].contiguous(), 3)
    with pytest.raises(ValueError):         # mixed devices
        da.flash_decode(q, k.cpu(), v, 3)
    with pytest.raises(ValueError):         # non-contiguous cache
        da.flash_decode(q, k.transpose(1, 2), v.transpose(1, 2), 3)
    with pytest.raises(ValueError):         # a tile not in 16-row chunks
        da.flash_decode(q, k, v, 3, blk=24)
    wq, wk, wv = _dense_problem(cuda_device, torch.bfloat16, 1, 32, 1, 256,
                                64)
    with pytest.raises(ValueError):         # G 32 not built at head_dim 256
        da.flash_decode(wq, wk, wv, 3)
    assert launch_counts()["flash_decode"] == 0


# ----------------------------------------------------------- SSD scan (K4)


def _ssd_problem(device, b, s, nh, p, n, *, dtype=torch.float32,
                 dt_dtype=torch.float32, seed=0, strong=False, weak=False):
    """The reference test's draws (dt in [0.1, 0.6), A = -exp(0.3 N)), a
    strong decay (dt 8, A -1), or a weak one (dt in [0.005, 0.03): a
    64-row chunk keeps ~a third of its state)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    x = torch.randn(b, s, nh, p, generator=g)
    dt = torch.rand(b, s, nh, generator=g) * 0.5 + 0.1
    a = -torch.exp(torch.randn(nh, generator=g) * 0.3)
    bm = torch.randn(b, s, n, generator=g)
    cm = torch.randn(b, s, n, generator=g)
    if strong:
        dt, a = torch.full_like(dt, 8.0), torch.full_like(a, -1.0)
    if weak:
        dt = dt * 0.05
    return (x.to(device, dtype), dt.to(device, dt_dtype), a.to(device),
            bm.to(device, dtype), cm.to(device, dtype))


def _ssd_close(got, want, dtype):
    """y: 2e-3 in f32; in bf16 3e-2 + 3e-2 x |value| (the plain version
    sums 256-row chunks, the kernel 32-row tiles, and y is rounded to
    bf16 after). The f32 state: 2e-3 + 2e-3 x |value|."""
    (y, h), (ry, rh) = got, want
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, rh, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,dt_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("chunk,nh,p,n,s", [
    (256, 24, 64, 128, 512),      # mamba2-130m's widths
    (256, 50, 64, 16, 256),       # hymba-1.5b's state width
    (64, 4, 16, 32, 192),
    (16, 8, 16, 16, 48),          # reduced mamba2: a tile of 32 rows, 16 more
])
def test_ssd_scan_matches_plain(cuda_device, dtype, dt_dtype, chunk, nh, p, n,
                                s):
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    args = _ssd_problem(cuda_device, 2, s, nh, p, n, dtype=dtype,
                        dt_dtype=dt_dtype, seed=s + n)
    want = ss.ssd_scan_plain(*args, chunk=chunk)
    got = ss.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _ssd_close(got, want, dtype)
    assert launch_counts()["ssd_scan"] == 1


@pytest.mark.parametrize("dtype,dt_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("s,nh,p,n,group", [
    (128, 24, 64, 128, 6),      # one bf16 chunk (two f32 chunks)
    (256, 24, 64, 128, 6),      # two
    (1024, 24, 64, 128, 6),     # eight
    (4096, 4, 64, 128, 6),
    (208, 50, 64, 16, 6),       # hymba's heads in groups of 6 and 2, s off
    (192, 8, 16, 32, 6),        # 8 heads: 6 and 2
    (48, 8, 16, 16, 3),
    (256, 24, 64, 128, 1), (256, 24, 64, 128, 8), (256, 24, 64, 128, 24)])
def test_ssd_scan_chunks_and_head_groups(cuda_device, dtype, dt_dtype, s, nh,
                                         p, n, group):
    """The chunk-parallel kernel at 1, 2, 8 and 32 chunks, s off the chunk,
    head counts off the group and groups of 1 to every head; one call,
    one count, whatever its launches."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    args = _ssd_problem(cuda_device, 2, s, nh, p, n, dtype=dtype,
                        dt_dtype=dt_dtype, seed=s + nh + group)
    got = ss.ssd_scan_at(*args, chunk=16, depth=2, group=group)
    want = ss.ssd_scan_plain(*args, chunk=16)
    torch.cuda.synchronize()
    _ssd_close(got, want, dtype)
    assert launch_counts()["ssd_scan"] == 1


def test_ssd_scan_strong_decay_stays_finite(cuda_device):
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.models.ssm import ssd_sequential

    args = _ssd_problem(cuda_device, 2, 64, 2, 16, 16, strong=True)
    got = ss.ssd_scan(*args, chunk=16)
    _ssd_close(got, ss.ssd_scan_plain(*args, chunk=16), torch.float32)
    _ssd_close(got, ssd_sequential(*args), torch.float32)


def test_ssd_scan_depths_and_strided_views(cuda_device):
    """Depths 1, 2, 5 and the deepest ring that fits (heads' tiles in flight
    a block), each recorded as run (5 is clamped); x, B and C as slices of
    one joint projection (the SSM block's layout)."""
    from repro_torch.core import autotune
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    b, s, nh, p, n = 2, 256, 4, 64, 128
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    joint = torch.randn(b, s, nh * p + 2 * n, generator=g).to(cuda_device,
                                                               torch.bfloat16)
    x = joint[..., :nh * p].reshape(b, s, nh, p)
    bm, cm = joint[..., nh * p:nh * p + n], joint[..., nh * p + n:]
    dt = (torch.rand(b, s, nh, generator=g) * 0.5 + 0.1).to(cuda_device)
    a = -torch.exp(torch.randn(nh, generator=g) * 0.3).to(cuda_device)
    want = ss.ssd_scan_plain(x, dt, a, bm, cm, chunk=64)
    deepest = ss.kernel_depth(64, p=p, n=n, itemsize=2, n_tiles=nh)
    for depth in (1, 2, 5, deepest):
        got = ss.ssd_scan(x, dt, a, bm, cm, chunk=64, depth=depth)
        assert autotune.last_choice("ssd_scan") == min(depth, deepest)
        _ssd_close(got, want, torch.bfloat16)
    assert deepest == 1   # one head's slot fits beside C, C B^T and scores


def test_ssm_forward_runs_the_kernel(cuda_device):
    """A reduced mamba2 layer on the card: its prefill scan is one K4
    launch, and agrees with the same layer on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.params import initialize

    cfg = get_config("mamba2-130m").reduced().replace(dtype="float32")
    g = torch.Generator()
    g.manual_seed(3)
    p = initialize(ssm.ssm_param_specs(cfg), g, "cpu")
    x = torch.randn(2, 64, cfg.d_model, generator=g) * 0.5
    want = ssm.ssm_forward(p, x, cfg)
    got = ssm.ssm_forward({k: t.to(cuda_device) for k, t in p.items()},
                          x.to(cuda_device), cfg)
    assert launch_counts()["ssd_scan"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)


def test_ssd_scan_raises_instead_of_falling_back(cuda_device):
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    x, dt, a, bm, cm = _ssd_problem(cuda_device, 1, 64, 2, 16, 16)
    with pytest.raises(TypeError):          # no f16 kernel
        ss.ssd_scan(x.half(), dt, a, bm.half(), cm.half(), chunk=16)
    with pytest.raises(TypeError):          # B in another type than x
        ss.ssd_scan(x, dt, a, bm.bfloat16(), cm, chunk=16)
    with pytest.raises(ValueError):         # rows off the 16-byte unit
        ss.ssd_scan(x[..., :3].contiguous(), dt, a, bm, cm, chunk=16)
    with pytest.raises(ValueError):         # state wider than the kernel's
        wide = torch.zeros(1, 64, 160, device=cuda_device)
        ss.ssd_scan(x, dt, a, wide, wide, chunk=16)
    with pytest.raises(ValueError):         # mixed devices
        ss.ssd_scan(x, dt.cpu(), a, bm, cm, chunk=16)
    assert launch_counts()["ssd_scan"] == 0


# ------------------------------------------------- SSD scan backward (K4)


def _ssd_bwd_close(got, want, dtype):
    """(dx, ddt, dA, dB, dC) against the plain backward: 2e-3 + 2e-3 x
    |value| in f32; in bf16 3e-2 + 3e-2 x |value| (the plain version sums
    the caller's chunks, the kernel 64-row chunks, and dx, dB and dC are
    rounded to bf16 after). ddt and dA are f32 in both."""
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    for name, a, b, t in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                             (dtype, torch.float32, torch.float32, dtype,
                              dtype)):
        assert a.dtype == t and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                   msg=name)


def _ssd_bwd_problem(device, b, s, nh, p, n, *, dtype, dt_dtype, seed,
                     with_dh, strong=False, weak=False):
    args = _ssd_problem(device, b, s, nh, p, n, dtype=dtype,
                        dt_dtype=dt_dtype, seed=seed, strong=strong,
                        weak=weak)
    g = torch.Generator(device="cpu")
    g.manual_seed(seed + 1)
    dy = torch.randn(b, s, nh, p, generator=g).to(device, dtype)
    dh = torch.randn(b, nh, p, n, generator=g).to(device) if with_dh \
        else None
    return args, dy, dh


@pytest.mark.parametrize("dtype,dt_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("chunk,nh,p,n,s,with_dh,weak", [
    (256, 24, 64, 128, 512, False, False),  # mamba2-130m's training shape
    (256, 50, 64, 16, 512, False, False),   # hymba-1.5b's
    (256, 24, 64, 128, 256, True, False),   # one caller chunk, 4 kernel chunks
    (64, 4, 16, 32, 192, True, False),
    (16, 8, 16, 16, 48, True, False),   # reduced mamba2: a partial 64-row chunk
    (32, 13, 32, 64, 96, False, False),  # 13 heads: past 12, off every group
    # a weak decay: what is carried across the 64-row chunks counts
    (256, 24, 64, 128, 512, True, True),
    (32, 13, 32, 64, 224, True, True),
])
def test_ssd_scan_bwd_matches_plain(cuda_device, dtype, dt_dtype, chunk, nh,
                                    p, n, s, with_dh, weak):
    """The backward kernel against its plain version: one call, one count
    (four launches), every gradient in its type."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    args, dy, dh = _ssd_bwd_problem(cuda_device, 2, s, nh, p, n, dtype=dtype,
                                    dt_dtype=dt_dtype, seed=s + nh,
                                    with_dh=with_dh, weak=weak)
    want = ss.ssd_scan_bwd_plain(*args, dy, dh, chunk=chunk)
    got = ss.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    _ssd_bwd_close(got, want, dtype)
    assert launch_counts()["ssd_scan_bwd"] == 1
    assert launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_bwd_depths_and_strided_views(cuda_device, dtype):
    """Depths 1, 2, 5, every head in one group and the solved depth (the
    heads a block walks), each recorded as run; x, B and C as slices of
    one joint projection, dt a strided view; dh_final None and given."""
    from repro_torch.core import autotune
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    b, s, nh, p, n = 2, 256, 12, 64, 128
    g = torch.Generator(device="cpu")
    g.manual_seed(7)
    joint = torch.randn(b, s, nh * p + 2 * n + 16, generator=g).to(
        cuda_device, dtype)
    x = joint[..., :nh * p].reshape(b, s, nh, p)
    bm = joint[..., nh * p:nh * p + n]
    cm = joint[..., nh * p + n:nh * p + 2 * n]
    dt = torch.nn.functional.softplus(joint[..., -16:].float())[..., :nh]
    assert dt.stride(1) == 16
    a = -torch.exp(torch.randn(nh, generator=g) * 0.3).to(cuda_device)
    dy = torch.randn(b, s, nh, p, generator=g).to(cuda_device, dtype)
    dh = torch.randn(b, nh, p, n, generator=g).to(cuda_device)
    for d_final in (None, dh):
        want = ss.ssd_scan_bwd_plain(x, dt, a, bm, cm, dy, d_final, chunk=64)
        for depth in (1, 2, 5, nh, None):
            before = launch_counts()["ssd_scan_bwd"]
            got = ss.ssd_scan_bwd(x, dt, a, bm, cm, dy, d_final, chunk=64,
                                  depth=depth)
            torch.cuda.synchronize()
            assert launch_counts()["ssd_scan_bwd"] == before + 1
            ran = autotune.last_choice("ssd_scan_bwd")
            assert ran == (depth if depth else ran) and 1 <= ran <= nh
            _ssd_bwd_close(got, want, dtype)


def test_ssd_scan_bwd_strong_decay_stays_finite(cuda_device):
    """dt 8, A -1: a chunk decays past exp(-88); no exponent of a positive
    argument, so every gradient stays finite and equals the plain one."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    args, dy, dh = _ssd_bwd_problem(cuda_device, 2, 128, 2, 16, 16,
                                    dtype=torch.float32,
                                    dt_dtype=torch.float32, seed=3,
                                    with_dh=True, strong=True)
    got = ss.ssd_scan_bwd(*args, dy, dh, chunk=16)
    _ssd_bwd_close(got, ss.ssd_scan_bwd_plain(*args, dy, dh, chunk=16),
                   torch.float32)


def test_ssd_op_differentiates_through_both_kernels(cuda_device):
    """`ops.ssd` under grad: the forward kernel and one backward call, the
    gradients of (y, h_final) equal the plain version's autograd; the raw
    `ssd_scan` wrapper (no backward of its own) still refuses grad."""
    from repro_torch.kernels import ring
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    args, dy, dh = _ssd_bwd_problem(cuda_device, 2, 128, 4, 16, 32,
                                    dtype=torch.float32,
                                    dt_dtype=torch.float32, seed=9,
                                    with_dh=True)
    grads = []
    for via in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        if via == "kernel":
            y, h = ops.ssd(*leaves, chunk=32)
        else:
            y, h = ss.ssd_scan_plain(*leaves, chunk=32)
        torch.autograd.backward((y, h), (dy, dh))
        grads.append([t.grad for t in leaves])
    assert launch_counts()["ssd_scan"] == 1
    assert launch_counts()["ssd_scan_bwd"] == 1
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    with pytest.raises(ring.NoBackwardError, match="ssd_scan"):
        ss.ssd_scan(args[0].clone().requires_grad_(True), *args[1:], chunk=32)


def test_ssd_scan_bwd_raises_instead_of_falling_back(cuda_device):
    from repro_torch.core.guard import KernelResourceError
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    x, dt, a, bm, cm = _ssd_problem(cuda_device, 1, 64, 2, 16, 16)
    dy = torch.randn_like(x)
    with pytest.raises(TypeError):          # dy in another type than x
        ss.ssd_scan_bwd(x, dt, a, bm, cm, dy.bfloat16(), chunk=16)
    with pytest.raises(ValueError):         # dy of another shape
        ss.ssd_scan_bwd(x, dt, a, bm, cm, dy[:, :32], chunk=16)
    with pytest.raises(ValueError):         # mixed devices
        ss.ssd_scan_bwd(x, dt, a, bm, cm, dy.cpu(), chunk=16)
    wide = _ssd_problem(cuda_device, 1, 64, 1, 128, 128)
    with pytest.raises(KernelResourceError):    # tiles over shared memory
        ss.ssd_scan_bwd(*wide, torch.randn_like(wide[0]), chunk=16)
    assert launch_counts()["ssd_scan_bwd"] == 0


# ------------------------------------------------- captured steps (graphs)


def test_capture_survives_dead_graphs_in_cycles(cuda_device):
    """Earlier graphs that died in reference cycles are not destroyed
    inside a later capture, even when the collector runs there: the
    capture completes and its replay is right."""
    import gc

    from repro_torch.core.step_graph import StepGraph

    def step(x, scale):
        return x * scale + 1.0

    def collecting_step(x, scale):
        if torch.cuda.is_current_stream_capturing():
            gc.collect()                    # a collection inside the capture
        return step(x, scale)

    gc.disable()                            # keep the dead graphs until then
    try:
        for _ in range(3):
            dead = StepGraph(step, "dead")
            x = torch.ones(64, device=cuda_device)
            dead((x,), (torch.tensor(2.0, device=cuda_device),))
            dead.cycle = dead
            del dead
        live = StepGraph(collecting_step, "live")
        x = torch.ones(64, device=cuda_device)
        live((x,), (torch.tensor(2.0, device=cuda_device),))
        out = live((x,), (torch.tensor(5.0, device=cuda_device),))
    finally:
        gc.enable()
    assert live.captures == 1 and live.replays == 1
    assert torch.equal(out, torch.full_like(x, 6.0))


def test_failed_capture_thaws_what_it_froze(cuda_device):
    """A capture that raises still thaws the objects it froze against
    the collector, and the error reaches the caller."""
    import gc

    from repro_torch.core.step_graph import StepGraph

    def failing_step(x, y):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fails inside the capture")
        return x + y

    x = torch.ones(64, device=cuda_device)
    y = torch.tensor(1.0, device=cuda_device)
    with pytest.raises(RuntimeError, match="inside the capture"):
        StepGraph(failing_step, "failing")((x,), (y,))
    assert gc.get_freeze_count() == 0
    step = StepGraph(lambda x, y: x + y, "ok")
    step((x,), (y,))
    assert step.captures == 1 and gc.get_freeze_count() == 0


def test_flash_decode_replays_with_pos_read_on_the_device(cuda_device):
    """K3 captured once with pos in a device buffer, then replayed at five
    positions written into that buffer: each replay equals the eager
    kernel and the plain version at the new pos, and counts one launch."""
    from repro_torch.core.step_graph import StepGraph

    q, k, v = _dense_problem(cuda_device, torch.bfloat16, 8, 32, 4, 128,
                             1056, seed=21)
    step = StepGraph(lambda q, k, v, pos: da.flash_decode(q, k, v, pos),
                     "flash_decode")
    first = torch.tensor(1040, dtype=torch.int32, device=cuda_device)
    step((q, k, v), (first,))                         # eager, then capture
    assert step.captures == 1
    for pos in (0, 63, 640, 1055, 2000):
        out = step((q, k, v), (torch.tensor(pos, dtype=torch.int32,
                                            device=cuda_device),))
        eager = da.flash_decode(q, k, v, pos)
        torch.testing.assert_close(out.float(), eager.float(),
                                   **DECODE_TOL[torch.bfloat16])
        torch.testing.assert_close(
            out.float(), da.flash_decode_plain(q, k, v, pos).float(),
            **DECODE_TOL[torch.bfloat16])
    assert step.captures == 1 and step.replays == 5
    assert launch_counts()["flash_decode"] == 1 + 5 + 5


def test_paged_decode_replays_new_tables_and_lengths(cuda_device):
    """K1 captured once, then replayed after other block tables and
    lengths (a zero-length row among them) are written into its buffers."""
    from repro_torch.core.step_graph import StepGraph

    q, kp, vp, bt, lens = _problem(cuda_device, torch.bfloat16,
                                   [40, 300, 17, 129], h=32, kh=4, d=128,
                                   blk=16, seed=4)
    step = StepGraph(lambda kp, vp, q, bt, lens:
                     da.paged_flash_decode(q, kp, vp, bt, lens),
                     "paged_decode")
    step((kp, vp), (q, bt, lens))
    g = torch.Generator(device="cpu")
    for seed in range(3):
        g.manual_seed(seed)
        perm = torch.randperm(bt.shape[1], generator=g)
        bt2 = bt[:, perm.to(cuda_device)].flip(0).contiguous()
        lens2 = (torch.randint(0, bt.shape[1] * 16, (bt.shape[0],),
                               generator=g, dtype=torch.int32)
                 .to(cuda_device))
        lens2[seed] = 0
        out = step((kp, vp), (q, bt2, lens2))
        want = da.paged_flash_decode_plain(q, kp, vp, bt2, lens2)
        live = lens2 > 0          # the plain version's empty rows: garbage
        torch.testing.assert_close(out[live].float(), want[live].float(),
                                   **DECODE_TOL[torch.bfloat16])
        assert not out[seed].float().abs().any()       # no live key: 0
    assert step.captures == 1 and step.replays == 3
    assert launch_counts()["paged_decode"] == 1 + 3


def test_gmm_replays_new_tokens(cuda_device):
    """K2 captured once (its weights' TMA map encoded at the capture),
    then replayed on other tokens written into its buffer."""
    from repro_torch.core.step_graph import StepGraph
    from repro_torch.kernels.moe_gmm import moe_gmm as mg

    tokens, w = _gmm_problem(cuda_device, torch.bfloat16, 8, 5, 2048, 768)
    step = StepGraph(lambda w, x: mg.gmm(x, w), "moe_gmm")
    step((w,), (tokens,))
    for seed in range(3):
        x, _ = _gmm_problem(cuda_device, torch.bfloat16, 8, 5, 2048, 768,
                            seed=seed + 1)
        out = step((w,), (x,))
        want = mg.gmm_plain(x, w).float()
        torch.testing.assert_close(out.float(), want, atol=3e-2, rtol=3e-2)
    assert step.captures == 1 and step.replays == 3
    assert launch_counts()["moe_gmm"] == 1 + 3


def _reduced_f32(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             param_dtype="float32")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    model = build_model(cfg)
    return cfg, model, model.init(g, "cuda")


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m",
                                  "mamba2-130m"])
def test_dense_decode_graph_equals_eager(cuda_device, arch):
    """Reduced archs in f32: eight steps through `jit_decode_step` (one
    eager step and its capture, then replays) against eight eager
    `decode_step`s on a copy of the same cache: identical greedy tokens,
    logits and caches within 2e-3, and the kernels' launch counts those
    of eight steps."""
    import repro_torch
    from repro_torch.core import step_graph
    from repro_torch.launch.serve import jit_decode_step

    cfg, model, params = _reduced_f32(arch)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (3, 32), generator=g,
                            device="cuda", dtype=torch.int32)
    cache, logits = model.prefill(params, {"tokens": prompts}, pad_to=48)
    eager = {"pos": cache["pos"].clone(),
             "layers": {k: t.clone() for k, t in cache["layers"].items()}}
    tok = e_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    repro_torch.reset()
    decode = jit_decode_step(model)
    for _ in range(8):
        logits, cache = decode(params, cache, {"tokens": tok})
        e_logits, eager = model.decode_step(params, eager, {"tokens": e_tok})
        torch.testing.assert_close(logits, e_logits, rtol=2e-3, atol=2e-3)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        e_tok = torch.argmax(e_logits, dim=-1).to(torch.int32)
        assert torch.equal(tok, e_tok)
    assert int(cache["pos"]) == int(eager["pos"]) == 40
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    for key, leaf in cache["layers"].items():
        torch.testing.assert_close(leaf, eager["layers"][key], rtol=2e-3,
                                   atol=2e-3)
    assert decode.graph.captures == 1 and decode.graph.replays == 7
    st = step_graph.stats()["by_name"]["dense_decode"]
    assert (st["captures"], st["replays"]) == (1, 7)
    want = 0 if cfg.family == "ssm" else 2 * 8 * cfg.n_layers
    assert launch_counts()["flash_decode"] == want       # graph + eager
    if cfg.moe:
        assert launch_counts()["moe_gmm"] == 2 * 8 * 3 * cfg.n_layers


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m"])
def test_prefill_chunk_graph_replays_equal_eager(cuda_device, arch):
    """Reduced archs in f32: chunks of one request through the prefiller's
    captured step at one (padded 8, table width 8) key, at several `start`
    / `n_valid` (a full chunk, chunks off a block boundary, one whose first
    page was copy-on-write forked between replays, and a retry of the last
    chunk), against the eager `prefill_chunk_paged` with int `start` /
    `n_valid` on a copy of the pools: the logits and every pool row
    bitwise equal after each chunk, one capture and no recapture."""
    import numpy as np

    from repro_torch.core import step_graph
    from repro_torch.serve.prefill import ChunkedPrefiller

    cfg, model, params = _reduced_f32(arch)
    blk, nb = 4, 24
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    shape = (cfg.n_layers, nb, blk, cfg.kv_heads, cfg.resolved_head_dim)
    kp = torch.randn(shape, generator=g, device="cuda")
    vp = torch.randn(shape, generator=g, device="cuda")
    ek, ev = kp.clone(), vp.clone()
    table = np.array([5, 9, 2, 14, 7, 11, 0, 0], np.int32)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, 24)
    pre = ChunkedPrefiller(model, blk, "cuda")
    # (start, n_valid, CoW fork before the chunk: (table slot, new page))
    chunks = [(0, 8, None), (8, 5, None), (13, 6, (3, 20)), (19, 5, None),
              (19, 5, None)]
    for start, n, fork in chunks:
        if fork is not None:          # the engine's `_copy_page`, in place
            slot, dst = fork
            for pools in (kp, vp, ek, ev):
                pools[:, dst] = pools[:, table[slot]]
            table[slot] = dst
        logits, out_k, out_v, _ = pre.run_chunk(
            params, kp, vp, prompt[start:start + n], table, start, n)
        assert out_k is kp and out_v is vp
        buf = np.zeros((1, 8), np.int64)
        buf[0, :n] = prompt[start:start + n]
        want, _, _ = model.prefill_chunk_paged(
            params, ek, ev, torch.from_numpy(table[None]).cuda(), start,
            {"tokens": torch.from_numpy(buf).cuda()}, n)
        assert torch.equal(logits, want), (start, n)
        assert torch.equal(kp, ek) and torch.equal(vp, ev), (start, n)
    assert list(pre.graphs) == [(8, 8)]
    graph = pre.graphs[(8, 8)]
    assert graph.captures == 1 and graph.replays == len(chunks) - 1
    st = step_graph.stats()["by_name"]["paged_prefill"]
    assert (st["captures"], st["replays"]) == (1, len(chunks) - 1)
    want = 3 * cfg.n_layers * 2 * len(chunks) if cfg.moe else 0
    assert launch_counts()["moe_gmm"] == want         # graph + eager


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-1b-a400m"])
def test_paged_engine_graph_equals_cpu(cuda_device, arch):
    """A reduced paged engine in f32 on the card (each round a replay, one
    capture per table width; each prefill chunk a replay, one capture per
    padded length and table width) against the same engine on the CPU:
    identical tokens, and the decode kernel launched n_layers times a
    round."""
    from repro_torch.core import step_graph
    from repro_torch.launch.serve import serve_paged

    import repro_torch

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    cfg, _, params = _reduced_f32(arch)
    kw = dict(batch=4, prompt_len=40, gen=8, block_size=4, seed=1,
              max_in_flight=3)
    cpu = serve_paged(cfg, device="cpu", params=to_cpu(params), **kw)
    repro_torch.reset()
    card = serve_paged(cfg, device="cuda", params=params, **kw)
    assert card["generated"] == cpu["generated"]
    by_name = step_graph.stats()["by_name"]
    decode, prefill = by_name["paged_decode"], by_name["paged_prefill"]
    assert decode["captures"] >= 1 and prefill["captures"] >= 1
    assert decode["captures"] + decode["replays"] == card["decode_rounds"]
    assert prefill["captures"] + prefill["replays"] == card["prefill_chunks"]
    assert prefill["replays"] >= 1
    assert set(by_name) == {"paged_decode", "paged_prefill"}
    counts = launch_counts()
    assert counts["paged_decode"] == cfg.n_layers * card["decode_rounds"]
    if cfg.moe:
        assert counts["moe_gmm"] == 3 * cfg.n_layers * (
            card["decode_rounds"] + card["prefill_chunks"])


# --------------------------------------------- the guard (core.guard) on card


def _guard_calls(device):
    """Each of the eight guarded wrappers once, at small f32 shapes."""
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    g = torch.Generator(device="cpu")
    g.manual_seed(21)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(device)

    paged = _problem(device, torch.float32, [17, 40], h=8, kh=2, d=64, blk=16)
    q, k, v = randn(2, 8, 64), randn(2, 80, 2, 64), randn(2, 80, 2, 64)
    tokens, w = randn(2, 16, 64), randn(2, 64, 256)
    joint = randn(1, 128, 2 * 64 + 2 * 64)
    x = joint[..., :128].reshape(1, 128, 2, 64)
    bm, cm = joint[..., 128:192], joint[..., 192:]
    dt = torch.rand(1, 128, 2, generator=g).to(device) * 0.5 + 0.1
    a = -torch.exp(randn(2) * 0.3)
    table = _table(device, 256, 128, torch.float32)
    idx = _ints(device, 256, 64)
    starts = torch.arange(0, 128, 16, dtype=torch.int32, device=device)
    uniq = torch.randperm(256, generator=g)[:64].int().to(device)
    upd = randn(64, 128)
    b, c = randn(256, 64), randn(256, 64)
    return {
        "paged_decode": lambda: da.paged_flash_decode(*paged),
        "moe_gmm": lambda: mg.gmm(tokens, w),
        "flash_decode": lambda: da.flash_decode(q, k, v, 70),
        "ssd_scan": lambda: ss.ssd_scan(x, dt, a, bm, cm, chunk=64),
        "row_gather": lambda: cg.row_gather(table, idx),
        "span_gather": lambda: cg.span_gather(table, starts, span=8),
        "scatter_add": lambda: sa.scatter_add_unique(table.clone(), uniq,
                                                     upd),
        "stream_triad": lambda: sc.triad(b, c, 2.5, rows=128),
    }


def test_guard_sentinel_over_the_eight_wrappers(cuda_device):
    """With the sentinel on full every wrapper's kernel is held against its
    plain version on the card: 8 checks, no mismatch, one launch each."""
    from repro_torch.core import guard

    calls = _guard_calls(cuda_device)
    guard.set_parity("full")
    for fn in calls.values():
        fn()
    s = guard.stats()
    assert (s["parity_checks"], s["parity_mismatches"]) == (8, 0)
    assert s["clean_calls"] == 8 and s["backoffs"] == 0
    assert all(launch_counts()[k] == 1 for k in calls)


def test_guard_poisoned_plain_raises_and_walks_to_one(cuda_device):
    """A wrong plain version around K5a's real attempt: every rung is
    checked again, the ladder halves to 1 and the call raises; the kernel's
    output is never swapped for the plain one."""
    from repro_torch.core import autotune, guard

    table = _table(cuda_device, 1024, 128, torch.float32)
    idx = _ints(cuda_device, 1024, 512)

    def attempt(d):
        blocks, slots = cg.row_gather_split(d, table)
        return cg.row_gather_at(table, idx, blocks_per_sm=blocks, slots=slots)

    guard.set_parity("full")
    with pytest.raises(guard.KernelParityError):
        guard.guarded_call(cg.row_gather_spec(8, 128, torch.float32),
                           (table, idx), attempt, depth=8, n_tiles=64,
                           plain=lambda t, i: cg.row_gather_plain(t, i) + 1)
    assert guard.last_ladder("row_gather") == [8, 4, 2, 1]
    assert autotune.quarantined_depths("row_gather") == [1, 2, 4, 8]
    assert launch_counts()["row_gather"] == 4


def test_guard_scatter_add_resource_ladder(cuda_device):
    """K6 asked for rings check_smem refuses (64 and 32 slots of 8 KiB): the
    refused launches wrote nothing, the ladder lands on 16 and the table is
    the plain version's, bit for bit; choose_depth avoids the refused."""
    from repro_torch.core import autotune, guard

    table = _table(cuda_device, 4096, 128, torch.float32)
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    idx = torch.randperm(4096, generator=g)[:1024].int().to(cuda_device)
    upd = torch.randn(1024, 128, generator=g).to(cuda_device)
    want = sa.scatter_add_unique_plain(table.clone(), idx, upd)
    spec = sa.scatter_add_spec(8, 128, torch.float32)
    res = guard.guarded_call(
        spec, (table, idx, upd),
        lambda d: sa.scatter_add_at(table, idx, upd, blocks_per_sm=1,
                                    slots=d),
        depth=64, n_tiles=128, plain=sa.updated_rows, in_place=True,
        written=lambda t: t.index_select(0, idx))
    assert res.depth == 16 and res.out is table
    assert guard.last_ladder("scatter_add") == [64, 32, 16]
    assert torch.equal(table, want)
    assert autotune.quarantined_depths("scatter_add") == [32, 64]
    assert autotune.choose_depth(spec.profile(), kernel="scatter_add",
                                 vars=spec.all_vars()) not in (32, 64)
    assert launch_counts()["scatter_add"] == 1


def test_guard_scatter_add_no_double_add_on_card(cuda_device):
    """A fault after K6's launch (NaN poisoning of what it wrote) raises at
    once: the updates are in the table exactly once."""
    from repro_torch.core import guard
    from repro_torch.serve import FaultInjector

    table = _table(cuda_device, 512, 64, torch.float32)
    g = torch.Generator(device="cpu")
    g.manual_seed(4)
    idx = torch.randperm(512, generator=g)[:128].int().to(cuda_device)
    upd = torch.randn(128, 64, generator=g).to(cuda_device)
    want = sa.scatter_add_unique_plain(table.clone(), idx, upd)
    guard.set_injector(FaultInjector(0, rates={"kernel_nan": 1.0}))
    with pytest.raises(guard.KernelNumericsError):
        sa.scatter_add_unique(table, idx, upd)
    assert len(guard.last_ladder("scatter_add")) == 1
    assert torch.equal(table, want)
    assert launch_counts()["scatter_add"] == 1


def test_guard_capture_skips_the_sentinel(cuda_device):
    """Inside a CUDA graph capture the guard runs the attempt once and
    polices nothing; neither the capture nor its replays add a parity
    check, and the replays compute the kernel's answer."""
    from repro_torch.core import guard

    table = _table(cuda_device, 256, 128, torch.float32)
    idx = _ints(cuda_device, 256, 64)
    guard.set_parity("full")
    cg.row_gather(table, idx)                    # eager: checked once
    assert guard.stats()["parity_checks"] == 1
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = cg.row_gather(table, idx)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert guard.stats()["parity_checks"] == 1
    assert torch.equal(out, cg.row_gather_plain(table, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guard_scatter_add_scan_of_the_written_rows(cuda_device, dtype):
    """K6's scan (`rows_finite`) on the card: the rows at the type's largest
    finite value pass, a NaN or an Inf in a written row is found, one in a
    row not written is not; through the wrapper a NaN update raises at
    once, with the updates added once."""
    from repro_torch.core import guard

    big = torch.full((4096, 128), torch.finfo(dtype).max, dtype=dtype,
                     device=cuda_device)
    idx = torch.arange(0, 4096, 2, dtype=torch.int32, device=cuda_device)
    assert bool(sa.rows_finite(big, idx)) and bool(sa.rows_finite(-big, idx))
    for bad in (float("nan"), float("inf"), float("-inf")):
        t = torch.zeros(4096, 128, dtype=dtype, device=cuda_device)
        t[2048, 5] = bad
        assert not bool(sa.rows_finite(t, idx))
        t[2048, 5], t[2049, 5] = 0, bad
        assert bool(sa.rows_finite(t, idx))
    table = _table(cuda_device, 512, 64, dtype)
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    uniq = torch.randperm(512, generator=g)[:128].int().to(cuda_device)
    upd = torch.randn(128, 64, generator=g).to(cuda_device, dtype)
    upd[7, 3] = float("nan")
    want = sa.scatter_add_unique_plain(table.clone(), uniq, upd)
    with pytest.raises(guard.KernelNumericsError):
        sa.scatter_add_unique(table, uniq, upd)
    assert len(guard.last_ladder("scatter_add")) == 1
    assert torch.equal(table.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(table), torch.nan_to_num(want))
    assert launch_counts()["scatter_add"] == 1


def test_guard_record_times_the_attempt_alone(cuda_device):
    """Inside `record()` a guarded call on the card records CUDA events
    around the attempt it returns; `rerun()` launches the same kernel at
    the same depth without the guard, and the device time it takes is of
    the order of the events' (the scan, which reads the output, and its
    sync stay outside them)."""
    from repro_torch.core import guard

    table = _table(cuda_device, 1 << 16, 128, torch.float32)
    idx = _ints(cuda_device, 1 << 16, 1 << 14)
    with guard.record() as calls:
        out = cg.row_gather(table, idx)
    res, = calls
    assert res.kernel == "row_gather" and res.events is not None
    assert res.device_s() > 0
    before = (guard.stats(), launch_counts()["row_gather"])
    again = res.rerun()
    torch.cuda.synchronize()
    assert torch.equal(again, out)
    assert guard.stats() == before[0]
    assert launch_counts()["row_gather"] == before[1] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_guard_scan_finds_one_nonfinite_value_on_card(cuda_device, dtype):
    """The guard's scan (min and max in one read) on the card: one NaN or
    Inf anywhere in a large tensor is found, the type's extremes are not."""
    from repro_torch.core import guard

    t = torch.full((1 << 20, 64), torch.finfo(dtype).max, dtype=dtype,
                   device=cuda_device)
    t[7, 0] = -torch.finfo(dtype).max
    assert guard.scan_output("k", t) is None
    for bad in (float("nan"), float("inf"), float("-inf")):
        for pos in (0, (1 << 19) + 3, (1 << 20) - 1):
            t[pos, 63] = bad
            assert isinstance(guard.scan_output("k", t),
                              guard.KernelNumericsError)
            t[pos, 63] = 1


# ------------------------------------------- K2's backward, and the others'


# The six products of a training step of granite-moe-1b-a400m (batch 8 x
# seq 512 = 4096 tokens) are the forwards of its gate/up (one token block
# shared by the 32 experts) and down projections and their backwards; and
# reduced and ragged shapes
GMM_GRAD_CASES = [
    (32, 4096, 1024, 512, True),     # gate / up: d tokens, d weights too
    (32, 4096, 512, 1024, False),    # down
    (4, 32, 64, 32, True),           # reduced granite-moe
    (4, 32, 32, 64, False),
    (3, 33, 200, 136, True),         # ragged C, dm and f
    (2, 7, 50, 36, False),           # rows off the 16-byte unit
]


def _gmm_grads(tokens, weights, upstream, via):
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.moe_gmm.ops import moe_gmm

    t = tokens.detach().clone().requires_grad_(True)
    w = weights.detach().clone().requires_grad_(True)
    if via == "kernel":
        out = moe_gmm(t, w)
    else:
        out = mg.gmm_plain(t.expand(w.shape[0], -1, -1), w)
    out.backward(upstream)
    return out.detach(), t.grad, w.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,dm,f,shared", GMM_GRAD_CASES)
def test_gmm_backward_matches_plain_autograd(cuda_device, dtype, e, c, dm,
                                              f, shared):
    """`moe_gmm`'s gradients through K2 (two more launches) against the
    plain version's autograd on the same card: the output, d tokens
    (summed over the experts for a shared block) and d weights."""
    g = torch.Generator(device="cpu")
    g.manual_seed(e + c + dm)
    tokens = torch.randn(1 if shared else e, c, dm, generator=g)
    w = torch.randn(e, dm, f, generator=g) * dm ** -0.5
    up = torch.randn(e, c, f, generator=g) * c ** -0.5
    tokens, w, up = (x.to(cuda_device, dtype) for x in (tokens, w, up))
    got = _gmm_grads(tokens, w, up, "kernel")
    torch.cuda.synchronize()
    assert launch_counts()["moe_gmm"] == 3
    want = _gmm_grads(tokens, w, up, "plain")
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])


def test_moe_layer_gradients_match_the_cpu(cuda_device):
    """A reduced f32 MoE layer's gradients on the card (K2 forward and
    backward: nine launches) against the same layer on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import initialize

    cfg = get_config("granite-moe-1b-a400m").reduced().replace(
        dtype="float32", param_dtype="float32")
    g = torch.Generator(device="cpu")
    g.manual_seed(4)
    p = initialize(moe.moe_param_specs(cfg), g, "cpu")
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    grads = []
    for dev in ("cpu", cuda_device):
        pd = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in p.items()}
        xd = x.detach().to(dev).requires_grad_(True)
        y, aux = moe.moe_dense(pd, xd, cfg)
        ((y ** 2).mean() + 0.01 * aux).backward()
        grads.append([xd.grad.cpu()] + [pd[k].grad.cpu() for k in sorted(p)])
    assert launch_counts()["moe_gmm"] == 9
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


def _no_backward_calls(device):
    """Each wrapper without a backward, called on card tensors of which
    the first requires grad: (kernel name, call)."""
    from repro_torch.kernels.coro_gather import coro_gather as cgm
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sam

    g = torch.Generator(device="cpu")
    g.manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(device)

    q, kc, vc = r(2, 4, 16), r(2, 32, 2, 16), r(2, 32, 2, 16)
    qp, kp, vp = r(2, 4, 16), r(8, 16, 2, 16), r(8, 16, 2, 16)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=device)
    lens = torch.tensor([20, 9], dtype=torch.int32, device=device)
    table = r(64, 32)
    idx = torch.arange(16, dtype=torch.int32, device=device)
    grad = torch.Tensor.requires_grad_
    return [
        ("flash_decode", lambda: da.flash_decode(grad(q), kc, vc, 20)),
        ("paged_decode", lambda: da.paged_flash_decode(grad(qp), kp, vp, bt,
                                                       lens)),
        ("row_gather", lambda: cgm.row_gather(grad(table), idx)),
        ("span_gather", lambda: cgm.span_gather(grad(table), idx[:4] * 8)),
        ("scatter_add", lambda: sam.scatter_add_unique(
            table.clone(), idx, grad(r(16, 32)))),
        ("stream_triad", lambda: sc.triad(grad(r(128, 4)), r(128, 4), 2.0)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_wrappers_without_backward_raise_under_grad(cuda_device, case):
    """A kernel with no backward never returns a tensor that cuts the
    graph: under grad mode an operand that requires grad raises the typed
    error naming the kernel, before any launch; under no_grad the same
    call launches."""
    from repro_torch.kernels import ring

    name, call = _no_backward_calls(cuda_device)[case]
    with pytest.raises(ring.NoBackwardError) as ei:
        call()
    assert ei.value.kernel == name and launch_counts()[name] == 0
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert launch_counts()[name] >= 1


def test_ssm_block_gradients_match_the_cpu(cuda_device):
    """A reduced f32 Mamba-2 block under grad on the card (joint layout:
    x, B and C strided slices of one projection): one forward K4 launch
    and one backward call, and every gradient equals the same block's on
    the CPU (plain versions) within 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.params import initialize

    cfg = get_config("mamba2-130m").reduced().replace(dtype="float32",
                                                      param_dtype="float32")
    g = torch.Generator(device="cpu")
    g.manual_seed(6)
    p = initialize(ssm.ssm_param_specs(cfg), g, "cpu")
    x = torch.randn(1, 64, cfg.d_model, generator=g)
    grads = []
    for dev in ("cpu", cuda_device):
        pd = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in p.items()}
        xd = x.detach().to(dev).requires_grad_(True)
        (ssm.ssm_forward(pd, xd, cfg) ** 2).mean().backward()
        grads.append([xd.grad.cpu()] + [pd[k].grad.cpu() for k in sorted(p)])
    assert launch_counts()["ssd_scan"] == 1
    assert launch_counts()["ssd_scan_bwd"] == 1
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
