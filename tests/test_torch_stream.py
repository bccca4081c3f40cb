"""The STREAM triad of the PyTorch port against the JAX reference.

The same numpy inputs go through the reference's op (the Pallas kernel in
interpret mode) and the port's op on the CPU (the kernel's plain version),
at the reference test's bounds: 1e-5 in f32, 2e-2 in bf16. The spec must
give the reference's context bytes and solved depth.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.kernels.stream_copy import stream_copy as ref_sc
from repro.kernels.stream_copy.ops import stream_triad as ref_stream_triad
from repro_torch.core import autotune, machine
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.stream_copy import stream_copy as sc
from repro_torch.kernels.stream_copy.ops import stream_triad

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n,d,rows,depth", [(256, 32, 64, 2),
                                            (512, 16, 128, 4),
                                            (384, 24, 128, None)])
def test_triad_matches_reference(dtype, tol, n, d, rows, depth):
    rng = np.random.RandomState(n + d)
    b = rng.randn(n, d).astype(np.float32)
    c = rng.randn(n, d).astype(np.float32)
    got = stream_triad(torch.from_numpy(b).to(DTYPES[dtype]),
                       torch.from_numpy(c).to(DTYPES[dtype]), 3.0, rows=rows,
                       depth=depth)
    want = ref_stream_triad(jnp.asarray(b, dtype), jnp.asarray(c, dtype), 3.0,
                            rows=rows, depth=depth)
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (n, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)
    assert launch_counts()["stream_triad"] == 0        # CPU: plain version


def test_scalar_is_rounded_to_the_array_type():
    """The reference passes the scalar in the arrays' type."""
    b = torch.zeros(128, 4, dtype=torch.bfloat16)
    c = torch.ones(128, 4, dtype=torch.bfloat16)
    got = sc.triad(b, c, 1.0 + 2.0 ** -10)          # not a bf16 value
    assert torch.equal(got, torch.ones_like(b))


@pytest.mark.parametrize("profile", ["h100", "v5e", "cpu-interpret"])
@pytest.mark.parametrize("rows,d,dtype", [(128, 64, "float32"),
                                          (128, 512, "float32"),
                                          (64, 128, "bfloat16")])
def test_spec_context_and_depth_match_reference(profile, rows, d, dtype):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    spec = sc.triad_spec(rows, d, DTYPES[dtype])
    ref_spec = ref_sc.triad_spec(rows, d, jnp.dtype(dtype))
    assert spec.name == ref_spec.name
    for depth in (1, 2, 7):
        assert spec.context_bytes(depth) == ref_spec.context_bytes(depth)
    assert autotune.choose_depth(spec.profile(), machine=mm,
                                 vars=spec.all_vars()) == \
        ref_autotune.choose_depth(ref_spec.profile(), machine=ref_mm,
                                  vars=ref_spec.all_vars())


def test_last_choice_is_clamped_to_what_shared_memory_holds():
    """[N, 128] f32 tiles of 128 rows: b and c take 128 KiB per slot, so
    one slot fits beside nothing else; the solve (2) is clamped to 1."""
    b = torch.zeros(256, 128)
    sc.triad(b, b, 1.0)
    assert autotune.last_choice("stream_triad") == 1
    sc.triad(torch.zeros(1024, 64), torch.zeros(1024, 64), 1.0)
    assert autotune.last_choice("stream_triad") == 2


def test_wrapper_rejects_bad_inputs():
    b = torch.zeros(100, 4)
    with pytest.raises(ValueError):
        sc.triad(b, b, 1.0)                          # 100 % 128
    with pytest.raises(ValueError):
        sc.triad(b, torch.zeros(100, 5), 1.0, rows=10)
    with pytest.raises(ValueError):
        sc.triad(b, b, 1.0, rows=10, depth=0)


@pytest.mark.parametrize("n,d,dtype,rows,depth,item", [
    (1 << 21, 128, "float32", 128, 1, 8),    # the GUPS path: 4 KiB items
    (1 << 21, 128, "bfloat16", 128, 1, 8),
    (1024, 64, "float32", 128, 2, 16),
    (1024, 64, "float32", 128, 3, 16),       # 24 rows: the 16-row divisor
    (640, 96, "float32", 64, 2, 8),
    (256, 128, "float32", 128, 2, 8),        # two tiles: clamped to one
    (64, 3, "float32", 2, 1, 1),             # 24-byte tiles: unit path
    (63, 3, "bfloat16", 1, 5, 1),
    (96, 40, "float32", 96, 1, 6)])          # rows off a power of two
def test_plan_items_divide_the_tile_and_fill_the_sm(n, d, dtype, rows, depth,
                                                    item):
    """An item is a divisor of the caller's tile, of whole 16-byte units
    when the tile is, at most depth x rows over the blocks an SM's threads
    allow; the blocks an SM holds are `ring.resident_blocks`'s, and the
    depth recorded is the tiles they hold, rounded up."""
    itemsize = DTYPES[dtype].itemsize
    p = sc.plan(n, d, itemsize, rows, depth)
    row_bytes = d * itemsize
    assert p.item_rows == item and rows % p.item_rows == 0
    assert p.items * p.item_rows == n
    if rows * row_bytes % 16 == 0:
        assert p.item_rows * row_bytes % 16 == 0
    smem = 2 * item * row_bytes + sc.BARRIER_BYTES \
        if item * row_bytes % 16 == 0 else 0
    assert p.blocks_per_sm == ring.resident_blocks(smem, sc.THREADS) == 16
    assert p.depth == -(-p.blocks_per_sm * p.item_rows // rows)
    clamped = ring.kernel_depth(depth, slot_bytes=2 * rows * row_bytes,
                                n_tiles=n // rows)
    most = clamped * rows // (ring.MAX_THREADS_PER_SM // sc.THREADS)
    assert p.item_rows <= most or p.item_rows == min(
        r for r in range(1, rows + 1) if rows % r == 0
        and (rows * row_bytes % 16 or r * row_bytes % 16 == 0))


def test_triad_records_the_plans_depth():
    b = torch.zeros(1 << 12, 128)
    sc.triad(b, b, 1.0)
    assert autotune.last_choice("stream_triad") == \
        sc.plan(1 << 12, 128, 4, 128, 1).depth == 1
    sc.triad(b, b, 1.0, depth=3)                   # a given depth: no record
    assert autotune.last_choice("stream_triad") == 1


def test_triad_at_takes_only_cuda_tensors_and_a_known_plan():
    b = torch.zeros(256, 16)
    with pytest.raises(ValueError):
        sc.triad_at(b, b, 1.0, item_rows=8)
    assert launch_counts()["stream_triad"] == 0
