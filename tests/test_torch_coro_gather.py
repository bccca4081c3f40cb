"""The coroutine gathers of the PyTorch port against the JAX reference.

The same numpy inputs, made from a seed, go through the reference's ops
(Pallas interpret mode, as its own tests run them) and the port's ops on
the CPU, where each wrapper runs its plain version. A gather is a copy:
outputs must be bitwise equal, in f32, bf16 and int32. The coalescing plan
must be the same arrays, and each spec must give the same context bytes
and, under one machine profile, the same solved depth as the reference's.
The CUDA kernels themselves are held to the plain versions on the card
(`test_torch_kernels_cuda.py`).
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.core.descriptors import plan_gather as ref_plan_gather
from repro.kernels.coro_gather import coro_gather as ref_cg
from repro.kernels.coro_gather.ops import coalesced_gather as ref_coalesced
from repro.kernels.coro_gather.ops import coro_gather as ref_coro_gather
from repro_torch.core import autotune, machine
from repro_torch.core.descriptors import apply_plan_reference, plan_gather
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.coro_gather import coro_gather as cg
from repro_torch.kernels.coro_gather.ops import coalesced_gather, coro_gather

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _same_machine(name="h100"):
    """Run both packages under one machine profile (the port's)."""
    mm = machine.set_machine(name)
    ref_machine.set_machine(ref_machine.MachineModel(**dataclasses.asdict(mm)))
    return mm


def _pair(a: np.ndarray, dtype: str):
    """The same table for both packages (bf16 rounded by both from f32)."""
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(DTYPES[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n_rows,d,n_idx", [(64, 128, 32), (256, 256, 61),
                                            (128, 8, 16)])
def test_coro_gather_matches_reference(dtype, n_rows, d, n_idx):
    rng = np.random.RandomState(n_rows + n_idx)
    ref_t, t = _pair((rng.randn(n_rows, d) * 10).astype(np.float32), dtype)
    idx = rng.randint(0, n_rows, n_idx).astype(np.int32)
    got = coro_gather(t, torch.from_numpy(idx))
    want = ref_coro_gather(ref_t, jnp.asarray(idx))
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (n_idx, d)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert launch_counts()["row_gather"] == 0          # CPU: plain version


@pytest.mark.parametrize("depth", [1, 2, 3, 8])
@pytest.mark.parametrize("rows_per_tile", [1, 4, 8])
def test_depth_tile_sweep_matches_reference(depth, rows_per_tile):
    rng = np.random.RandomState(depth * 10 + rows_per_tile)
    table = rng.randn(128, 64).astype(np.float32)
    idx = rng.randint(0, 128, 48).astype(np.int32)
    got = coro_gather(torch.from_numpy(table), idx, depth=depth,
                      rows_per_tile=rows_per_tile)
    want = ref_coro_gather(jnp.asarray(table), jnp.asarray(idx), depth=depth,
                           rows_per_tile=rows_per_tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("span", [2, 4, 8])
@pytest.mark.parametrize("seed,n_idx", [(0, 1), (1, 7), (2, 33), (3, 80),
                                        (4, 52)])
def test_coalesced_gather_matches_reference(seed, n_idx, span):
    r = np.random.RandomState(seed)
    table = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    run = np.arange(r.randint(0, 32), dtype=np.int64)
    idx = np.concatenate([run, r.randint(0, 64, n_idx)])[:max(n_idx, 1)]
    idx = np.asarray(idx, np.int32)
    got, plan = coalesced_gather(torch.from_numpy(table), idx, span=span)
    want, ref_plan = ref_coalesced(jnp.asarray(table), idx, span=span)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), table[idx])
    for field in ("span_starts", "singles", "order"):
        np.testing.assert_array_equal(getattr(plan, field),
                                      getattr(ref_plan, field))


def test_coalescing_saves_requests_on_streams():
    out, plan = coalesced_gather(torch.zeros(512, 8), np.arange(256), span=8)
    assert plan.n_spans == 32 and plan.n_singles == 0
    assert plan.coalescing_ratio() == 32 / 256
    assert tuple(out.shape) == (256, 8)


@pytest.mark.parametrize("span", [2, 4, 8, 16])
@pytest.mark.parametrize("seed,size", [(0, 0), (1, 1), (2, 13), (3, 50),
                                       (4, 128), (5, 200)])
def test_plan_gather_identical_to_reference(seed, size, span):
    r = np.random.RandomState(seed)
    run_len = r.randint(0, max(size, 1) + 1)
    start = r.randint(0, 128 - max(run_len, 1))
    idx = np.concatenate([np.arange(start, start + run_len),
                          r.randint(0, 128, max(size - run_len, 0))])[:size]
    plan, ref_plan = plan_gather(idx, span=span), ref_plan_gather(idx,
                                                                   span=span)
    for field in ("span_starts", "singles", "order"):
        a, b = getattr(plan, field), getattr(ref_plan, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (plan.span, plan.n_requests) == (ref_plan.span, ref_plan.n_requests)
    table = np.arange(128 * 4, dtype=np.float32).reshape(128, 4)
    np.testing.assert_array_equal(apply_plan_reference(plan, table),
                                  table[idx.astype(np.int64)])


def test_span_gather_plain_matches_reference_kernel():
    rng = np.random.RandomState(5)
    table = rng.randn(96, 24).astype(np.float32)
    starts = rng.randint(0, 96 - 4, 11).astype(np.int32)
    got = cg.span_gather(torch.from_numpy(table), torch.from_numpy(starts),
                         span=4, depth=2)
    want = ref_cg.span_gather(jnp.asarray(table), jnp.asarray(starts), span=4,
                              depth=2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("profile", ["h100", "v5e", "cpu-interpret"])
@pytest.mark.parametrize("rows_per_tile,d,dtype", [(8, 128, "float32"),
                                                   (4, 256, "bfloat16"),
                                                   (1, 16, "int32")])
def test_specs_context_and_depth_match_reference(profile, rows_per_tile, d,
                                                 dtype):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    pairs = ((cg.row_gather_spec(rows_per_tile, d, DTYPES[dtype]),
              ref_cg.row_gather_spec(rows_per_tile, d, jnp.dtype(dtype))),
             (cg.span_gather_spec(rows_per_tile, d, DTYPES[dtype]),
              ref_cg.span_gather_spec(rows_per_tile, d, jnp.dtype(dtype))))
    for spec, ref_spec in pairs:
        assert spec.name == ref_spec.name
        for depth in (1, 2, 7):
            assert spec.context_bytes(depth) == ref_spec.context_bytes(depth)
            assert spec.context_bytes(depth, baseline=True) == \
                ref_spec.context_bytes(depth, baseline=True)
        assert spec.profile() == type(spec.profile())(
            **dataclasses.asdict(ref_spec.profile()))
        assert autotune.choose_depth(spec.profile(), machine=mm,
                                     vars=spec.all_vars()) == \
            ref_autotune.choose_depth(ref_spec.profile(), machine=ref_mm,
                                      vars=ref_spec.all_vars())


@pytest.mark.parametrize("n_rows,d,n_idx", [(512, 128, 256), (2048, 256, 512)])
def test_last_choice_matches_reference(n_rows, d, n_idx):
    """A depth=None call records the depth it ran, as the reference does."""
    _same_machine()
    rng = np.random.RandomState(0)
    table = rng.randn(n_rows, d).astype(np.float32)
    idx = rng.randint(0, n_rows, n_idx).astype(np.int32)
    coro_gather(torch.from_numpy(table), idx)
    ref_coro_gather(jnp.asarray(table), jnp.asarray(idx))
    assert autotune.last_choice("row_gather") == \
        ref_autotune.last_choice("row_gather")


def test_profiles_match_reference():
    for name in ("profile_row_gather", "profile_span_gather",
                 "profile_scatter_add", "profile_triad"):
        for args in ((8, 128, 4), (4, 64, 2), (128, 512, 4)):
            got = getattr(autotune, name)(*args)
            want = getattr(ref_autotune, name)(*args)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_wrappers_reject_bad_inputs():
    table = torch.zeros(16, 4)
    with pytest.raises(ValueError):
        cg.row_gather(table, torch.zeros(10, dtype=torch.int32))  # 10 % 8
    with pytest.raises(ValueError):
        cg.row_gather(table, torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        cg.row_gather(table, torch.zeros(8, dtype=torch.int32), depth=0)
    with pytest.raises(ValueError):
        cg.span_gather(table, torch.zeros(3, dtype=torch.int32), span=0)


@pytest.mark.parametrize("depth", [1, 15, 16, 17, 56, 64, 65, 1000])
@pytest.mark.parametrize("slot_bytes", [64, 4096, 8192, 131072])
def test_kernel_depth_never_exceeds_max_depth(depth, slot_bytes):
    """The depth a kernel runs is at most MAX_DEPTH (its deepest compiled
    wait), what shared memory holds and the tile count."""
    for n_tiles in (3, 100, 10 ** 6):
        got = ring.kernel_depth(depth, slot_bytes=slot_bytes, n_tiles=n_tiles)
        assert got == max(1, min(depth, ring.MAX_DEPTH,
                                 ring.SMEM_LIMIT // slot_bytes, n_tiles))
        assert 1 <= got <= ring.MAX_DEPTH


def test_max_depth_matches_the_kernels_wait():
    header = (Path(ring.__file__).parent / "csrc" / "coro_ring.cuh").read_text()
    assert int(re.search(r"kMaxDepth = (\d+);", header).group(1)) == \
        ring.MAX_DEPTH


def test_recorded_depth_is_the_depth_that_runs():
    """A far-memory solve deeper than MAX_DEPTH is recorded as it runs."""
    mm = machine.set_machine("v5e-far-800ns")
    spec = cg.row_gather_spec(1, 16, torch.float32)
    solved = autotune.choose_depth(spec.profile(), machine=mm,
                                   vars=spec.all_vars())
    assert solved > ring.MAX_DEPTH
    cg.row_gather(torch.zeros(4096, 16), torch.zeros(4096, dtype=torch.int32),
                  rows_per_tile=1)
    assert autotune.last_choice("row_gather") == ring.MAX_DEPTH


@pytest.mark.parametrize("dtype,d,offset,unit", [
    (torch.float32, 128, 0, 16), (torch.float32, 5, 0, 4),
    (torch.float32, 128, 1, 4), (torch.bfloat16, 6, 0, 4),
    (torch.bfloat16, 5, 0, 2), (torch.bfloat16, 8, 1, 2),
    (torch.uint8, 6, 0, 2), (torch.uint8, 5, 0, 1), (torch.uint8, 16, 3, 1)])
def test_copy_unit_and_ring_bytes(dtype, d, offset, unit):
    """The widest unit that divides the rows and the base pointer; a 2- or
    1-byte unit takes a 4-byte slot in the ring."""
    t = torch.zeros(64 * d + offset, dtype=dtype)[offset:].view(64, d)
    row_bytes = d * t.element_size()
    assert ring.copy_unit(row_bytes, (t,)) == unit
    assert ring.ring_bytes(row_bytes, unit) == row_bytes * max(1, 4 // unit)
