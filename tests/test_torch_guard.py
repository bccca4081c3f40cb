"""The port's kernel-substrate guard against the JAX reference's.

The scenarios of ``tests/test_guard.py`` that keep their meaning without a
fallback twin run through both packages on the same fake specs, operands
and injector schedules, and the depth ladders, quarantined depths and
counters must agree. Where the reference's ladder ends in its jnp twin,
the port's raises the last typed error, and a parity mismatch raises
instead of returning the plain version's output. The port's own rules
follow: the scatter-add, which writes in place, is retried only after a
refused launch and is policed on the rows it wrote; a failed build and a
sticky CUDA error are not retried; a call inside a CUDA graph capture runs
once, unpoliced; a ladder that lands lower records the depth it ran.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import context as ref_context
from repro.core import guard as ref_guard
from repro.core import machine as ref_machine
from repro.core import schedule as ref_schedule
from repro.kernels.coro_gather.ops import coro_gather as ref_coro_gather
from repro.serve import FaultInjector as RefFaultInjector
from repro_torch.configs import get_config
from repro_torch.core import autotune, context, guard, machine, schedule
from repro_torch.core.guard import (
    KernelCompileError,
    KernelNumericsError,
    KernelParityError,
    KernelResourceError,
    SubstrateError,
)
from repro_torch.kernels import build, launch_counts, ring
from repro_torch.kernels.coro_gather import coro_gather as cg
from repro_torch.kernels.coro_gather.ops import coro_gather
from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
from repro_torch.serve import (
    FaultInjector,
    PagedServingEngine,
    TERMINAL_STATES,
)


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _fake_spec(name):
    """Just enough spec surface for guarded_call: a name and no streams."""
    return types.SimpleNamespace(name=name, loads=(), stores=())


def _gather_operands(n_idx=64):
    rng = np.random.RandomState(0)
    table = rng.randn(256, 128).astype(np.float32)
    idx = rng.randint(0, 256, n_idx).astype(np.int32)
    return ((jnp.asarray(table), jnp.asarray(idx)),
            (torch.from_numpy(table), torch.from_numpy(idx)))


def _counts(s, keys=("guarded_calls", "clean_calls", "backoffs",
                     "parity_checks", "parity_mismatches", "numerics_faults",
                     "injected_faults")):
    return {k: s[k] for k in keys}


# ---------------------------------------------------------------- taxonomy


@pytest.mark.parametrize("cls", ["KernelCompileError", "KernelResourceError",
                                 "KernelNumericsError", "KernelParityError"])
def test_taxonomy_carries_launch_context(cls):
    for mod in (ref_guard, guard):
        e = getattr(mod, cls)("boom", kernel="row_gather", machine="v5e",
                              depth=8, tile=(8, 128))
        assert isinstance(e, mod.SubstrateError) and isinstance(e,
                                                                RuntimeError)
        assert (e.kernel, e.machine, e.depth, e.tile) == (
            "row_gather", "v5e", 8, (8, 128))
        assert "kernel=row_gather" in str(e) and "depth=8" in str(e)
    e = getattr(guard, cls)("boom", kernel="k")
    assert e.machine == machine.get_machine().name
    assert (e.refused, e.retriable) == (False, True)


def test_classification_resource_vs_compile():
    """A raw failure that names resource exhaustion classifies as
    `KernelResourceError`, anything else as `KernelCompileError`, with the
    original as __cause__, in both packages (no twin in the reference)."""
    def oom(_d):
        raise RuntimeError("RESOURCE_EXHAUSTED: scoped vmem request")

    def lowering(_d):
        raise ValueError("unsupported lowering")

    for attempt, want in ((oom, "KernelResourceError"),
                          (lowering, "KernelCompileError")):
        with pytest.raises(getattr(ref_guard, want)) as ref:
            ref_guard.guarded_call(_fake_spec("no_twin_classify_probe"), (),
                                   attempt, depth=1, n_tiles=1)
        with pytest.raises(getattr(guard, want)) as got:
            guard.guarded_call(_fake_spec("no_twin_classify_probe"), (),
                               attempt, depth=1, n_tiles=1,
                               plain=lambda: None)
        assert type(got.value.__cause__) is type(ref.value.__cause__)
        assert guard.last_ladder("no_twin_classify_probe") == \
            ref_guard.last_ladder("no_twin_classify_probe") == [1]


def test_classification_of_device_failures():
    """Device out-of-memory is a refused launch (retried, even in place);
    a sticky CUDA error is not retriable (the context is lost)."""
    err = guard._classify(torch.cuda.OutOfMemoryError("CUDA out of memory"),
                          "k", 4, None)
    assert isinstance(err, KernelResourceError) and err.refused
    err = guard._classify(RuntimeError("CUDA error: an illegal memory access "
                                       "was encountered"), "k", 4, None)
    assert isinstance(err, KernelCompileError) and not err.retriable


class _FakeLib:
    class _Str:
        def __call__(self, err):
            return f"error {err}".encode()

    repro_cuda_error_string = _Str()


@pytest.mark.parametrize("code,cls,refused,retriable", [
    (2, KernelResourceError, True, True),
    (701, KernelResourceError, True, True),
    (700, KernelCompileError, False, False),
    (719, KernelCompileError, False, False),
    (1, KernelCompileError, False, True),
])
def test_launch_status_marks(code, cls, refused, retriable):
    """`ring.raise_on_error` tells the ladder what a CUDA status means:
    codes 2 and 701 refused the launch before the kernel ran, a sticky code
    lost the context."""
    with pytest.raises(cls) as ei:
        ring.raise_on_error(code, _FakeLib(), kernel="k", depth=4, tile=(8,))
    assert (ei.value.refused, ei.value.retriable) == (refused, retriable)
    ring.raise_on_error(0, _FakeLib(), kernel="k", depth=4, tile=(8,))


def test_sticky_error_is_not_retried():
    calls = []

    def attempt(d):
        calls.append(d)
        ring.raise_on_error(700, _FakeLib(), kernel="sticky_probe", depth=d,
                            tile=(8,))

    with pytest.raises(KernelCompileError):
        guard.guarded_call(_fake_spec("sticky_probe"), (), attempt, depth=8,
                           n_tiles=8, plain=lambda: None)
    assert calls == [8] and guard.stats()["backoffs"] == 0
    assert autotune.quarantined_depths("sticky_probe") == [8]


# ---------------------------------------------------------------- policing


def test_scan_output_flags_nonfinite_floats_only():
    bad = np.array([1.0, np.nan], np.float32)
    for mod, arr in ((ref_guard, jnp.asarray), (guard, torch.from_numpy)):
        assert mod.scan_output("k", arr(np.ones(4, np.float32))) is None
        assert mod.scan_output("k", arr(np.arange(4))) is None
        err = mod.scan_output("k", [arr(np.ones(3, np.float32)), arr(bad)],
                              depth=2)
        assert isinstance(err, mod.KernelNumericsError) and err.depth == 2
    assert guard.stats()["numerics_faults"] == \
        ref_guard.stats()["numerics_faults"] == 1


@pytest.mark.parametrize("site,cls", [("kernel_compile", "KernelCompileError"),
                                      ("kernel_oom", "KernelResourceError"),
                                      ("kernel_nan", "KernelNumericsError")])
def test_check_injected_raises_typed_errors(site, cls):
    with pytest.raises(getattr(ref_guard, cls)):
        ref_guard.check_injected("paged_decode_round",
                                 RefFaultInjector(0, rates={site: 1.0}),
                                 round=3)
    with pytest.raises(getattr(guard, cls)) as ei:
        guard.check_injected("paged_decode_round",
                             FaultInjector(0, rates={site: 1.0}), round=3)
    assert ei.value.refused       # the engine checks before the step runs
    assert guard.stats()["injected_faults"] == \
        ref_guard.stats()["injected_faults"] == 1


# ------------------------------------------------------------------ ladder


def _both_gathers(rates, depth=8):
    """coro_gather in both packages under the same injector schedule; the
    port's raises (returned), the reference's answers from its twin."""
    (rt, ri), (pt, pi) = _gather_operands()
    ref_guard.set_injector(RefFaultInjector(0, rates=rates))
    ref_out = ref_coro_gather(rt, ri, depth=depth)
    guard.set_injector(FaultInjector(0, rates=rates))
    with pytest.raises(SubstrateError) as ei:
        coro_gather(pt, pi, depth=depth)
    return ref_out, ei.value


def test_compile_fault_walks_the_ladder_then_raises():
    """Every attempt fails like a compile error: both ladders halve to
    depth 1 and quarantine every depth; the reference's twin answers, the
    port raises the last typed error."""
    _, err = _both_gathers({"kernel_compile": 1.0})
    assert isinstance(err, KernelCompileError) and err.depth == 1
    ladder = guard.last_ladder("row_gather")
    assert ladder == ref_guard.last_ladder("row_gather") == [8, 4, 2, 1]
    assert autotune.quarantined_depths("row_gather") == \
        ref_autotune.quarantined_depths("row_gather") == [1, 2, 4, 8]
    keys = ("backoffs", "injected_faults", "clean_calls", "guarded_calls")
    assert _counts(guard.stats(), keys) == _counts(ref_guard.stats(), keys)
    assert guard.stats()["backoffs"] == 3
    assert launch_counts()["row_gather"] == 0


def test_nan_injection_caught_by_scan_then_raises():
    """kernel_nan poisons every finished attempt's output: the scan turns
    each into KernelNumericsError down the ladder in both packages."""
    ref_out, err = _both_gathers({"kernel_nan": 1.0})
    assert bool(jnp.isfinite(ref_out).all())
    assert isinstance(err, KernelNumericsError)
    assert guard.last_ladder("row_gather") == \
        ref_guard.last_ladder("row_gather") == [8, 4, 2, 1]
    keys = ("numerics_faults", "injected_faults", "backoffs")
    assert _counts(guard.stats(), keys) == _counts(ref_guard.stats(), keys)


def test_ladder_landing_records_the_depth_run():
    """One refused attempt: the ladder lands one rung down, the wrapper
    returns the plain answer on the CPU and records the depth it ran
    (blocks x slots of the landing split), as the reference records its
    landing depth."""
    (rt, ri), (pt, pi) = _gather_operands()
    rates = {"kernel_oom": 1.0}
    ref_guard.set_injector(RefFaultInjector(0, rates=rates, max_faults=1))
    ref_coro_gather(rt, ri, depth=8)
    guard.set_injector(FaultInjector(0, rates=rates, max_faults=1))
    out = coro_gather(pt, pi, depth=8)
    assert torch.equal(out, cg.row_gather_plain(pt, pi))
    assert guard.last_ladder("row_gather") == \
        ref_guard.last_ladder("row_gather") == [8, 4]
    blocks, slots = cg.row_gather_split(4, pt)
    assert autotune.last_choice("row_gather") == blocks * slots
    assert ref_autotune.last_choice("row_gather") == 4
    s = guard.stats()
    assert (s["backoffs"], s["clean_calls"]) == (1, 0)


@pytest.mark.parametrize("profile", ["v5e", "v5e-far-800ns"])
def test_quarantine_steers_choose_depth(profile):
    """choose_depth never proposes a quarantined (machine, kernel, depth):
    it halves below the quarantined configs instead, in both packages."""
    machine.set_machine(profile)
    ref_machine.set_machine(profile)
    prof = autotune.profile_row_gather(8, 512, 4)
    seen = {}
    for mod in (autotune, ref_autotune):
        d = mod.choose_depth(prof, kernel="quarantine_probe")
        assert d >= 2
        walk = [d]
        while d > 1:
            mod.quarantine_config("quarantine_probe", d)
            assert mod.is_quarantined("quarantine_probe", d)
            nd = mod.choose_depth(prof, kernel="quarantine_probe")
            assert nd < d and not mod.is_quarantined("quarantine_probe", nd)
            d = nd
            walk.append(d)
        seen[mod.__name__] = (walk, mod.quarantined_depths("quarantine_probe"))
        quarantined = mod.telemetry_summary()["substrate"]["quarantined"]
        assert {"kernel": "quarantine_probe", "depth": walk[0]} in quarantined
        mod.clear_quarantine("quarantine_probe")
        assert not mod.quarantined_depths("quarantine_probe")
    assert seen["repro_torch.core.autotune"] == seen["repro.core.autotune"]


def test_clear_samples_clears_quarantine():
    for mod in (autotune, ref_autotune):
        mod.quarantine_config("clear_probe", 4)
        mod.quarantine_config("other_probe", 4)
        mod.clear_samples("clear_probe")
        assert mod.quarantined_depths("clear_probe") == []
        assert mod.quarantined_depths("other_probe") == [4]
        mod.clear_samples()
        assert mod.quarantined_depths("other_probe") == []


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("depth", [1, 4])
def test_parity_sentinel_catches_poisoned_kernel(depth):
    """A kernel that silently computes the wrong answer is caught by the
    sentinel: the port walks the ladder, every rung checked again, and
    raises `KernelParityError`; it never returns the plain answer."""
    x = np.arange(8.0, dtype=np.float32)
    guard.set_parity("full")
    ref_guard.set_parity("full")
    import repro.kernels as ref_kernels
    ref_kernels.register_twin("parity_probe", lambda spec, v: v + 1.0)
    try:
        rx = jnp.asarray(x)
        res = ref_guard.guarded_call(_fake_spec("parity_probe"), (rx,),
                                     lambda d: rx + 2.0, depth=depth,
                                     n_tiles=depth)
    finally:
        ref_kernels._TWINS.pop("parity_probe", None)
    assert res.path == "twin"
    px = torch.from_numpy(x)
    with pytest.raises(KernelParityError):
        guard.guarded_call(_fake_spec("parity_probe"), (px,),
                           lambda d: px + 2.0, depth=depth, n_tiles=depth,
                           plain=lambda v: v + 1.0)
    ladder = guard.last_ladder("parity_probe")
    assert ladder == [depth] + ([2, 1] if depth == 4 else [])
    assert ladder[0] == ref_guard.last_ladder("parity_probe")[0]
    s = guard.stats()
    assert s["parity_checks"] == s["parity_mismatches"] == len(ladder)
    assert autotune.quarantined_depths("parity_probe") == sorted(ladder)
    assert ref_autotune.quarantined_depths("parity_probe") == [depth]


def test_parity_strict_raises():
    x = np.arange(4.0, dtype=np.float32)
    guard.set_parity("full")
    guard.set_strict(True)
    px = torch.from_numpy(x)
    with pytest.raises(KernelParityError):
        guard.guarded_call(_fake_spec("parity_strict_probe"), (px,),
                           lambda d: px * 3.0, depth=4, n_tiles=4,
                           plain=lambda v: v * 2.0)
    assert guard.last_ladder("parity_strict_probe") == [4]
    assert guard.stats()["backoffs"] == 0


def test_parity_sampled_is_deterministic_1_in_n():
    """sampled mode checks call 1, N+1, 2N+1, ... per (machine, kernel)."""
    import repro.kernels as ref_kernels

    guard.set_parity("sampled", every=3)
    ref_guard.set_parity("sampled", every=3)
    ref_kernels.register_twin("parity_sample_probe", lambda spec, v: v)
    try:
        rx, px = jnp.ones(4), torch.ones(4)
        for _ in range(7):
            ref_guard.guarded_call(_fake_spec("parity_sample_probe"), (rx,),
                                   lambda d: rx, depth=1, n_tiles=1)
            guard.guarded_call(_fake_spec("parity_sample_probe"), (px,),
                               lambda d: px, depth=1, n_tiles=1,
                               plain=lambda v: v)
    finally:
        ref_kernels._TWINS.pop("parity_sample_probe", None)
    assert guard.stats()["parity_checks"] == \
        ref_guard.stats()["parity_checks"] == 3   # calls 1, 4, 7


def test_parity_clean_kernel_passes_full_check():
    """The row gather against its plain version: full parity on a clean
    call records a check and no mismatch, in both packages."""
    (rt, ri), (pt, pi) = _gather_operands(32)
    guard.set_parity("full")
    ref_guard.set_parity("full")
    ref = ref_coro_gather(rt, ri)
    out = coro_gather(pt, pi)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for s in (guard.stats(), ref_guard.stats()):
        assert s["parity_checks"] >= 1 and s["parity_mismatches"] == 0
        assert s["clean_calls"] >= 1


# ------------------------------------------------------------------ strict


def test_strict_clean_path_records_zero_degradation():
    guard.set_strict(True)
    ref_guard.set_strict(True)
    (rt, ri), (pt, pi) = _gather_operands(32)
    np.testing.assert_array_equal(coro_gather(pt, pi).numpy(),
                                  np.asarray(ref_coro_gather(rt, ri)))
    for s in (guard.stats(), ref_guard.stats()):
        assert s["clean_calls"] >= 1 and s["backoffs"] == 0 and s["strict"]


def test_strict_surfaces_first_failure():
    guard.set_strict(True)
    ref_guard.set_strict(True)
    rates = {"kernel_compile": 1.0}
    guard.set_injector(FaultInjector(0, rates=rates))
    ref_guard.set_injector(RefFaultInjector(0, rates=rates))
    (rt, ri), (pt, pi) = _gather_operands(32)
    with pytest.raises(ref_guard.KernelCompileError):
        ref_coro_gather(rt, ri)
    with pytest.raises(KernelCompileError) as ei:
        coro_gather(pt, pi)
    assert ei.value.kernel == "row_gather"
    assert len(guard.last_ladder("row_gather")) == \
        len(ref_guard.last_ladder("row_gather")) == 1


# ------------------------------------------- the in-place scatter-add (K6)


def _scatter_operands(seed=0, n=32, rows=128, d=16):
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(rows, d).astype(np.float32))
    idx = torch.from_numpy(rng.permutation(rows)[:n].astype(np.int32))
    upd = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    return table, idx, upd


def _added_once(table0, idx, upd):
    want = table0.clone()
    want[idx.long()] += upd
    return want


def test_scatter_add_post_launch_fault_is_not_retried():
    """NaN poisoning after the launch raises at once: the updates are in
    the table exactly once, never added again by a retry."""
    table, idx, upd = _scatter_operands()
    table0 = table.clone()
    guard.set_injector(FaultInjector(0, rates={"kernel_nan": 1.0}))
    with pytest.raises(KernelNumericsError):
        sa.scatter_add_unique(table, idx, upd, depth=8)
    assert guard.last_ladder("scatter_add") == [4]   # 32 rows: 4 tiles
    assert torch.equal(table, _added_once(table0, idx, upd))
    assert guard.stats()["backoffs"] == 0


def test_scatter_add_fault_after_writing_raises_at_once():
    """A failure that is not a refused launch, after the attempt wrote the
    table, is raised at once: one attempt, one add."""
    table, idx, upd = _scatter_operands(1)
    table0 = table.clone()
    calls = []

    def attempt(d):
        calls.append(d)
        sa.scatter_add_unique_plain(table, idx, upd)
        raise RuntimeError("unspecified failure after the launch")

    with pytest.raises(KernelCompileError):
        guard.guarded_call(sa.scatter_add_spec(8, 16, torch.float32),
                           (table, idx, upd), attempt, depth=4, n_tiles=4,
                           plain=sa.updated_rows, in_place=True)
    assert calls == [4]
    assert torch.equal(table, _added_once(table0, idx, upd))


def test_scatter_add_refused_launch_is_retried():
    """A refused launch wrote nothing, so the ladder may retry it: the
    updates land once, at the next rung."""
    table, idx, upd = _scatter_operands(2)
    table0 = table.clone()
    guard.set_injector(FaultInjector(0, rates={"kernel_oom": 1.0},
                                     max_faults=1))
    out = sa.scatter_add_unique(table, idx, upd, depth=4)
    assert out is table and guard.last_ladder("scatter_add") == [4, 2]
    assert torch.equal(table, _added_once(table0, idx, upd))
    assert autotune.quarantined_depths("scatter_add") == [4]


def test_scatter_add_sentinel_uses_the_gathered_rows():
    """The sentinel's reference is table[idx] gathered before the launch
    plus the updates, compared with table[idx] after it; a kernel that
    adds twice is caught and raised at once (no retry)."""
    guard.set_parity("full")
    table, idx, upd = _scatter_operands(3)
    table0 = table.clone()
    sa.scatter_add_unique(table, idx, upd)
    assert torch.equal(table, _added_once(table0, idx, upd))
    s = guard.stats()
    assert (s["parity_checks"], s["parity_mismatches"]) == (1, 0)

    table, idx, upd = _scatter_operands(4)
    calls = []

    def twice(d):
        calls.append(d)
        sa.scatter_add_unique_plain(table, idx, upd)
        return sa.scatter_add_unique_plain(table, idx, upd)

    with pytest.raises(KernelParityError):
        guard.guarded_call(sa.scatter_add_spec(8, 16, torch.float32),
                           (table, idx, upd), twice, depth=4, n_tiles=4,
                           plain=sa.updated_rows, in_place=True,
                           written=lambda t: t.index_select(0, idx))
    assert calls == [4]
    assert guard.stats()["parity_mismatches"] == 1


@pytest.mark.parametrize("check", ["written", "finite"])
def test_scatter_add_device_oom_after_the_launch_is_not_retried(check):
    """Device out-of-memory raised by the checks of what the attempt wrote
    (the gather of the written rows, the scan's temporaries) came after
    the launch: it is not a refused launch, so the in-place kernel raises
    at once, after one attempt and one add."""
    table, idx, upd = _scatter_operands(5)
    table0 = table.clone()
    calls = []

    def attempt(d):
        calls.append(d)
        return sa.scatter_add_unique_plain(table, idx, upd)

    def oom(t):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (checks)")

    kw = {"written": oom} if check == "written" else \
        {"written": lambda t: t.index_select(0, idx), "finite": oom}
    with pytest.raises(KernelResourceError) as ei:
        guard.guarded_call(sa.scatter_add_spec(8, 16, torch.float32),
                           (table, idx, upd), attempt, depth=4, n_tiles=4,
                           plain=sa.updated_rows, in_place=True, **kw)
    assert not ei.value.refused
    assert calls == [4] and guard.last_ladder("scatter_add") == [4]
    assert torch.equal(table, _added_once(table0, idx, upd))
    assert guard.stats()["backoffs"] == 0


def test_device_oom_inside_the_attempt_is_a_refused_launch():
    """An attempt allocates before it launches, so out-of-memory raised by
    the attempt itself is refused, and out-of-memory raised after it is not."""
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert guard._classify(exc, "k", 4, None).refused
    assert not guard._classify(exc, "k", 4, None, launched=True).refused


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_finite_reads_the_written_rows_only(dtype):
    """The scatter-add's scan: a NaN or an Inf in a written row is found,
    one in a row not written is not, and rows at the type's largest finite
    value never overflow the bag sums into a false alarm."""
    big = torch.full((4096, 16), torch.finfo(dtype).max, dtype=dtype)
    idx = torch.arange(0, 4096, 2, dtype=torch.int32)
    assert bool(sa.rows_finite(big, idx)) and bool(sa.rows_finite(-big, idx))
    for bad in (float("nan"), float("inf"), float("-inf")):
        t = torch.zeros(4096, 16, dtype=dtype)
        t[2048, 5] = bad
        assert not bool(sa.rows_finite(t, idx))
        t[2048, 5], t[2049, 5] = 0, bad          # 2049 is not written
        assert bool(sa.rows_finite(t, idx))
    assert bool(sa.rows_finite(big, idx[:0]))


def test_scatter_add_scan_catches_nonfinite_written_rows():
    """A NaN update makes the written rows non-finite: the scan, which
    reads them in the table, raises at once, with one add; a NaN in a row
    the call does not write is not its fault."""
    table, idx, upd = _scatter_operands(6)
    spare = int(np.setdiff1d(np.arange(table.shape[0]), idx.numpy())[0])
    table[spare, 0] = float("nan")
    sa.scatter_add_unique(table, idx, upd)
    assert guard.stats()["numerics_faults"] == 0
    upd[3, 2] = float("nan")
    table0 = table.clone()
    with pytest.raises(KernelNumericsError):
        sa.scatter_add_unique(table, idx, upd, depth=4)
    assert guard.last_ladder("scatter_add") == [4]
    want = _added_once(table0, idx, upd)
    assert torch.equal(table.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(table), torch.nan_to_num(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_scan_finds_one_nonfinite_value_anywhere(dtype, bad):
    """The scan reads a tensor's min and max: one NaN or Inf at any
    position of a strided nest is found, the type's extremes are not."""
    big = torch.tensor([torch.finfo(dtype).max, -torch.finfo(dtype).max,
                        torch.finfo(dtype).tiny], dtype=dtype)
    assert guard.scan_output("k", (big, torch.zeros(0, dtype=dtype))) is None
    for pos in (0, 17, 299):
        t = torch.randn(300, 4).to(dtype)
        t[pos, 2] = bad
        assert isinstance(guard.scan_output("k", {"a": [t[:, ::2]]}),
                          KernelNumericsError)
        assert guard.scan_output("k", t[:, :2]) is None


def test_record_hands_back_each_call_and_its_launch():
    """Inside `record()` every guarded call appends its result; `rerun()`
    runs the attempt that produced it at the depth it landed on, without
    the guard (no count moves); CPU operands record no events. Outside it
    nothing is kept."""
    (_, _), (table, idx) = _gather_operands(64)
    guard.set_injector(FaultInjector(0, rates={"kernel_oom": 1.0},
                                     max_faults=1))
    with guard.record() as calls:
        out = cg.row_gather(table, idx, depth=8)
        with guard.record() as inner:
            cg.row_gather(table, idx, depth=2)
        cg.span_gather(table, torch.arange(0, 64, 8, dtype=torch.int32),
                       span=8)
    assert [(c.kernel, c.depth, c.path) for c in calls] == [
        ("row_gather", 4, "backoff"), ("span_gather", 8, "clean")]
    assert [c.depth for c in inner] == [2]
    assert calls[0].out is out and calls[0].events is None
    before = guard.stats()
    assert torch.equal(calls[0].rerun(), out)
    assert guard.stats() == before
    with pytest.raises(ValueError):
        calls[0].device_s()
    guard.set_injector(None)
    res = guard.guarded_call(_fake_spec("unrecorded"), (table,),
                             lambda d: table[:d], depth=3, n_tiles=0,
                             plain=lambda t: t[:3])
    assert res.rerun is not None and guard._recording.calls is None


# ------------------------------------------------------- build and capture


def test_build_failure_is_not_retried(monkeypatch, tmp_path):
    """A failed build is the same source at every depth: the ladder raises
    at once, after one build attempt (nvcc here always fails)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    monkeypatch.setattr(build, "_loaded", {})
    loads = []
    real_load = build.load

    def counting_load(source):
        loads.append(source)
        return real_load(source)

    monkeypatch.setattr(build, "load", counting_load)

    def attempt(d):
        return ring.library(cg.SOURCE, "repro_gather", cg._ARGTYPES)

    with pytest.raises(KernelCompileError) as ei:
        guard.guarded_call(cg.row_gather_spec(8, 128, torch.float32), (),
                           attempt, depth=8, n_tiles=8, plain=lambda: None)
    assert not ei.value.retriable and ei.value.refused
    assert "nvcc failed" in str(ei.value)
    assert len(loads) == 1 and guard.last_ladder("row_gather") == [8]
    assert guard.stats()["backoffs"] == 0


def test_capture_runs_the_attempt_once_unpoliced(monkeypatch):
    """Inside a CUDA graph capture nothing can be read back: the call runs
    its attempt once at its depth, with no scan, sentinel, injection or
    ladder (the card test captures a real graph)."""
    monkeypatch.setattr(guard, "_capturing", lambda operands: True)
    guard.set_parity("full")
    guard.set_injector(FaultInjector(0, rates={"kernel_compile": 1.0,
                                               "kernel_nan": 1.0}))
    calls, plains = [], []
    x = torch.ones(4)

    def attempt(d):
        calls.append(d)
        return torch.full((4,), float("nan"))

    res = guard.guarded_call(_fake_spec("capture_probe"), (x,), attempt,
                             depth=8, n_tiles=4,
                             plain=lambda v: plains.append(v) or v)
    assert calls == [4] and plains == [] and res.path == "clean"
    assert bool(torch.isnan(res.out).all())
    s = guard.stats()
    assert (s["parity_checks"], s["numerics_faults"],
            s["injected_faults"]) == (0, 0, 0)


def test_capturing_is_false_for_cpu_operands():
    assert not guard._capturing((torch.ones(2), 3))


# --------------------------------------------------- reference parity bits


def test_static_prefetch_depth_and_classify_all_match_reference():
    for profile in ("v5e", "v5e-far-800ns", "nh-g"):
        machine.set_machine(profile)
        ref_machine.set_machine(profile)
        for tile, flops in ((1 << 12, 1e3), (1 << 16, 1e6), (1 << 20, 1e9)):
            p = schedule.TileProfile(tile_bytes=tile, flops_per_tile=flops)
            rp = ref_schedule.TileProfile(tile_bytes=tile,
                                          flops_per_tile=flops)
            for lat in (1e-7, 1e-6, 5e-6):
                for mshr in (4, 16):
                    assert schedule.static_prefetch_depth(
                        p, latency_s=lat, mshr_limit=mshr) == \
                        ref_schedule.static_prefetch_depth(
                            rp, latency_s=lat, mshr_limit=mshr)
    kw = [dict(), dict(read_only=True), dict(carries_dependence=True),
          dict(carries_dependence=True, commutative=True)]
    vs = [context.var(f"v{i}", (4, 8), "float32", **k)
          for i, k in enumerate(kw)]
    rvs = [ref_context.var(f"v{i}", (4, 8), "float32", **k)
           for i, k in enumerate(kw)]
    assert {k: v.value for k, v in context.classify_all(vs).items()} == \
        {k: v.value for k, v in ref_context.classify_all(rvs).items()}


def test_profile_gmm_and_last_profile_match_reference():
    machine.set_machine("v5e")
    ref_machine.set_machine("v5e")
    p = autotune.profile_gmm(16, 512, 128, 2, f_total=1024)
    rp = ref_autotune.profile_gmm(16, 512, 128, 2, f_total=1024)
    assert (p.tile_bytes, p.flops_per_tile, p.shared_bytes) == \
        (rp.tile_bytes, rp.flops_per_tile, rp.shared_bytes)
    assert autotune.choose_depth(p, kernel="gmm_probe") == \
        ref_autotune.choose_depth(rp, kernel="gmm_probe")
    assert autotune.last_profile("gmm_probe") == p
    assert autotune.last_profile("other_probe") is None


# ---------------------------------------------------------- engine + chaos


def test_engine_kernel_chaos_terminal_and_replayable():
    """Kernel-site chaos (compile / oom / nan at the engine's checks and,
    through the guard's injector, inside every guarded kernel call) drains
    every request to a terminal state with ZERO parity mismatches, and
    replays bit for bit across two identical runs."""
    cfg = get_config("yi-6b").reduced().replace(dtype="float32",
                                                param_dtype="float32")
    rates = {"pool_exhausted": 0.05, "kernel_compile": 0.25,
             "kernel_oom": 0.2, "kernel_nan": 0.2}
    guard.set_parity("sampled")

    def run():
        rng = np.random.default_rng(11)
        inj = FaultInjector(9, rates=rates)
        guard.set_injector(inj)
        eng = PagedServingEngine(cfg, block_size=4, num_blocks=12,
                                 faults=inj, max_in_flight=3, device="cpu")
        rids = [eng.submit(rng.integers(0, cfg.vocab,
                                        int(rng.integers(3, 9))),
                           max_new_tokens=2) for _ in range(6)]
        stats = eng.run()
        eng.pager.check_invariants(
            eng.prefix_cache.block_refs() if eng.prefix_cache else None)
        outcomes = [(eng.request(r).state, eng.request(r).finish_reason,
                     tuple(eng.request(r).generated)) for r in rids]
        return outcomes, inj.stats(), stats

    out1, inj1, stats1 = run()
    out2, inj2, _ = run()
    assert all(state in TERMINAL_STATES for state, _, _ in out1)
    assert out1 == out2 and inj1 == inj2
    kernel_hits = sum(inj1["by_site"].get(s, 0) for s in
                      ("kernel_compile", "kernel_oom", "kernel_nan"))
    assert kernel_hits > 0, inj1
    sub = guard.stats()
    assert sub["injected_faults"] > 0 and sub["guarded_calls"] > 0
    assert sub["parity_mismatches"] == 0
    assert stats1["substrate"]["parity_mismatches"] == 0
