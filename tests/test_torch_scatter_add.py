"""The coroutine scatter-add of the PyTorch port against the JAX reference.

The same numpy inputs, made from a seed, go through the reference's op
(dedup + the Pallas kernel in interpret mode) and the port's op on the CPU
(dedup + the kernel's plain version). Tolerances: 2e-3 in f32, 3e-2 in
bf16, where the port sums duplicate updates in f32 and the reference in
bf16. `dedup_rmw` must give identical arrays, the kernel on duplicate-free
rows must equal the reference's kernel bit for bit (one add, rounded once),
and the spec must give the reference's context bytes and solved depth. The
per-SM split of the depth (`scatter_add_split`) must fit one SM and give 4
blocks of 7 slots at the GUPS shape, a solved call records blocks x slots,
and `scatter_add_at` refuses CPU tensors and bad splits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.core.descriptors import dedup_rmw as ref_dedup_rmw
from repro.kernels.coro_scatter_add import coro_scatter_add as ref_sa
from repro.kernels.coro_scatter_add.ops import \
    coro_scatter_add as ref_coro_scatter_add
from repro_torch.core import autotune, machine
from repro_torch.core.descriptors import dedup_rmw
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
from repro_torch.kernels.coro_scatter_add.ops import coro_scatter_add

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-3, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", [(64, 32, 40), (128, 64, 50)])
def test_coro_scatter_add_matches_reference(dtype, n, d, k):
    rng = np.random.RandomState(n + k)
    table = rng.randn(n, d).astype(np.float32)
    idx = rng.randint(0, n, k).astype(np.int32)
    upd = rng.randn(k, d).astype(np.float32)
    t = torch.from_numpy(table).to(DTYPES[dtype])
    got = coro_scatter_add(t, idx, torch.from_numpy(upd).to(DTYPES[dtype]))
    want = ref_coro_scatter_add(jnp.asarray(table, dtype), idx,
                                jnp.asarray(upd, dtype))
    assert got.dtype == t.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # the op leaves its input as it was (the reference's functional result)
    np.testing.assert_array_equal(_f32(t), _f32(torch.from_numpy(table).to(
        DTYPES[dtype])))
    assert launch_counts()["scatter_add"] == 0          # CPU: plain version


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 5), (2, 17), (3, 40), (4, 27),
                                    (5, 33)])
def test_duplicates_accumulate_like_reference(seed, k):
    idx = np.asarray(np.random.RandomState(seed).randint(0, 32, k), np.int32)
    upd = np.ones((k, 8), np.float32)
    got = coro_scatter_add(torch.zeros(32, 8), idx, torch.from_numpy(upd))
    want = ref_coro_scatter_add(jnp.zeros((32, 8), jnp.float32), idx,
                                jnp.asarray(upd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    counts = np.zeros(32)
    np.add.at(counts, idx, 1.0)
    np.testing.assert_array_equal(got.numpy()[:, 0], counts)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed,size", [(0, 1), (1, 7), (2, 23), (3, 60),
                                       (4, 41), (5, 300)])
def test_dedup_rmw_identical_to_reference(seed, size, dtype):
    r = np.random.RandomState(seed)
    idx = np.asarray(r.randint(0, 32, size), np.int64)
    upd = r.randn(size, 3).astype(dtype)
    uniq, summed = dedup_rmw(idx, upd)
    ref_uniq, ref_summed = ref_dedup_rmw(idx, upd)
    assert uniq.dtype == ref_uniq.dtype and summed.dtype == ref_summed.dtype
    np.testing.assert_array_equal(uniq, ref_uniq)
    np.testing.assert_array_equal(summed, ref_summed)
    assert len(np.unique(uniq)) == len(uniq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [1, 2, None])
def test_unique_kernel_bitwise_like_reference(dtype, depth):
    """One add per element, in f32 and rounded once: the plain version the
    wrapper runs on the CPU equals the reference kernel bit for bit."""
    rng = np.random.RandomState(7)
    table = rng.randn(96, 16).astype(np.float32)
    idx = rng.permutation(96)[:40].astype(np.int32)
    upd = rng.randn(40, 16).astype(np.float32)
    t = torch.from_numpy(table.copy()).to(DTYPES[dtype])  # updated in place
    got = sa.scatter_add_unique(t, torch.from_numpy(idx),
                                torch.from_numpy(upd).to(DTYPES[dtype]),
                                depth=depth)
    assert got is t                                     # in place
    want = ref_sa.scatter_add_unique(jnp.asarray(table, dtype),
                                     jnp.asarray(idx), jnp.asarray(upd, dtype),
                                     depth=depth, interpret=True)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_padding_rows_and_full_table():
    """Padding takes unused rows with zero updates; a table whose every row
    is a target cannot be padded, in both packages."""
    idx = np.array([3, 1, 3], np.int32)
    got = coro_scatter_add(torch.zeros(8, 4), idx, torch.ones(3, 4))
    np.testing.assert_array_equal(got.numpy()[:, 0],
                                  [0, 1, 0, 2, 0, 0, 0, 0])
    full = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError):
        coro_scatter_add(torch.zeros(5, 4), full, torch.ones(5, 4))
    with pytest.raises(ValueError):
        ref_coro_scatter_add(jnp.zeros((5, 4)), full, jnp.ones((5, 4)))


@pytest.mark.parametrize("profile", ["h100", "v5e", "cpu-interpret"])
@pytest.mark.parametrize("rows_per_tile,d,dtype", [(8, 128, "float32"),
                                                   (4, 64, "bfloat16")])
def test_spec_context_and_depth_match_reference(profile, rows_per_tile, d,
                                                dtype):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    spec = sa.scatter_add_spec(rows_per_tile, d, DTYPES[dtype])
    ref_spec = ref_sa.scatter_add_spec(rows_per_tile, d, jnp.dtype(dtype))
    assert spec.name == ref_spec.name
    for depth in (1, 2, 7):
        assert spec.context_bytes(depth) == ref_spec.context_bytes(depth)
        assert spec.context_bytes(depth, baseline=True) == \
            ref_spec.context_bytes(depth, baseline=True)
    assert autotune.choose_depth(spec.profile(), machine=mm,
                                 vars=spec.all_vars()) == \
        ref_autotune.choose_depth(ref_spec.profile(), machine=ref_mm,
                                  vars=ref_spec.all_vars())


def test_wrapper_rejects_bad_inputs():
    table = torch.zeros(16, 4)
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        sa.scatter_add_unique(table, idx, torch.zeros(8, 3))
    with pytest.raises(ValueError):
        sa.scatter_add_unique(table, idx[:6], torch.zeros(6, 4))   # 6 % 8
    with pytest.raises(ValueError):
        sa.scatter_add_unique(table, idx, torch.zeros(8, 4), depth=0)


def _same_machine(name="h100"):
    mm = machine.set_machine(name)
    ref_machine.set_machine(ref_machine.MachineModel(**dataclasses.asdict(mm)))
    return mm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 64, 5])
@pytest.mark.parametrize("rows_per_tile", [1, 4, 8])
def test_split_respects_the_sm(dtype, d, rows_per_tile):
    """The per-SM split of every clamped depth 1-64 at the kernel's slot
    bytes (a tile of table rows and its update rows): blocks that fit one
    SM's threads and shared memory with the runtime's reservation per
    block, each ring within one block's limit, at least 2 slots a block
    (one block of 1 slot at depth 1), blocks x slots >= depth."""
    table = torch.zeros(64, d, dtype=DTYPES[dtype])
    upd = torch.zeros(8, d, dtype=DTYPES[dtype])
    row_bytes = d * table.element_size()
    slot_bytes = ring.ring_bytes(2 * rows_per_tile * row_bytes,
                                 ring.copy_unit(row_bytes, (table, upd)))
    for depth in range(1, 65):
        depth = ring.kernel_depth(depth, slot_bytes=slot_bytes,
                                  n_tiles=10 ** 6)
        blocks, slots = sa.scatter_add_split(depth, table, upd,
                                             rows_per_tile)
        assert (blocks, slots) == ring.split_depth(
            depth, slot_bytes=slot_bytes, threads=sa.THREADS)
        assert blocks * sa.THREADS <= ring.MAX_THREADS_PER_SM
        assert blocks * (slots * slot_bytes + ring.SMEM_RESERVED) <= \
            ring.SM_SMEM
        assert slots * slot_bytes <= ring.SMEM_LIMIT
        assert 1 <= slots <= ring.MAX_DEPTH and blocks * slots >= depth
        assert slots >= 2 or depth == 1


def test_gups_shape_splits_into_four_blocks_of_seven():
    """The GUPS path's scatter-add (512 B rows, 8 a tile, table and update
    rows: 8 KiB slots) solves depth 28 on the h100 profile and runs it as
    4 blocks of 7 slots, which fill one SM's 228 KiB exactly."""
    _same_machine()
    table, upd = torch.zeros(64, 128), torch.zeros(8, 128)
    spec = sa.scatter_add_spec(8, 128, torch.float32)
    solved = autotune.choose_depth(spec.profile(), vars=spec.all_vars())
    depth = ring.kernel_depth(solved, slot_bytes=8192, n_tiles=1 << 19)
    assert depth == 28
    assert sa.scatter_add_split(depth, table, upd) == (4, 7)
    assert 4 * (7 * 8192 + ring.SMEM_RESERVED) == ring.SM_SMEM


@pytest.mark.parametrize("n_rows,d,n_idx,dtype", [
    (96, 16, 40, "float32"), (512, 128, 256, "float32"),
    (256, 64, 48, "bfloat16"), (64, 5, 16, "bfloat16")])
def test_recorded_depth_is_the_split_of_the_reference_choice(n_rows, d, n_idx,
                                                             dtype):
    """A depth=None call records blocks x slots of the reference's choice
    passed through the port's split (`scatter_add_split`, the wrapper's
    own function), on CPU tensors as on the card."""
    _same_machine()
    rng = np.random.RandomState(2)
    table = rng.randn(n_rows, d).astype(np.float32)
    idx = rng.permutation(n_rows)[:n_idx].astype(np.int32)
    upd = rng.randn(n_idx, d).astype(np.float32)
    t = torch.from_numpy(table).to(DTYPES[dtype])
    u = torch.from_numpy(upd).to(DTYPES[dtype])
    sa.scatter_add_unique(t, torch.from_numpy(idx), u)
    ref_sa.scatter_add_unique(jnp.asarray(table, dtype), jnp.asarray(idx),
                              jnp.asarray(upd, dtype), interpret=True)
    blocks, slots = sa.scatter_add_split(
        ref_autotune.last_choice("scatter_add"), t, u)
    assert autotune.last_choice("scatter_add") == blocks * slots
    assert launch_counts()["scatter_add"] == 0          # CPU: plain version


@pytest.mark.parametrize("blocks,slots", [(0, 7), (4, 0), (4, 65), (-1, 2)])
def test_scatter_add_at_refuses_bad_splits(blocks, slots):
    table = torch.zeros(16, 4)
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="blocks_per_sm >= 1"):
        sa.scatter_add_at(table, idx, torch.ones(8, 4), blocks_per_sm=blocks,
                          slots=slots)
    assert not table.any()


def test_scatter_add_at_refuses_cpu_tensors():
    """`scatter_add_at` launches the kernel or raises: it never runs the
    plain version."""
    table = torch.zeros(16, 4)
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sa.scatter_add_at(table, idx, torch.ones(8, 4), blocks_per_sm=4,
                          slots=7)
    with pytest.raises(ValueError):                      # 6 % 8
        sa.scatter_add_at(table, idx[:6], torch.ones(6, 4), blocks_per_sm=4,
                          slots=7)
    assert not table.any()
    assert launch_counts()["scatter_add"] == 0
