"""The coroutine scatter-add of the PyTorch port against the JAX reference.

The same numpy inputs, made from a seed, go through the reference's op
(dedup + the Pallas kernel in interpret mode) and the port's op on the CPU
(dedup + the kernel's plain version). Tolerances: 2e-3 in f32, 3e-2 in
bf16, where the port sums duplicate updates in f32 and the reference in
bf16. `dedup_rmw` must give identical arrays, the kernel on duplicate-free
rows must equal the reference's kernel bit for bit (one add, rounded once),
and the spec must give the reference's context bytes and solved depth.
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
from repro_torch.kernels import launch_counts
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
