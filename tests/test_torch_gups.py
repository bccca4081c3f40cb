"""The port's GUPS launcher, kernel bench and paper model against the
reference's example, CI smoke, benchmark rows and `core.sim`.

Both packages run under one machine profile (the port's `h100`, given to
the reference as a `MachineModel`). `repro_torch.launch.gups` at its
default size must print what ``examples/gups_coro.py`` prints — the depths
and their context bytes, the coalescing ratio, the depth solve at 200 and
800 ns and the model's speedups — and give the same gathered and updated
tables (2e-3); ``--smoke`` must give ``scripts/machine_smoke.py``'s record.
Without ``--device cpu`` the launchers raise where there is no CUDA device.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import machine as ref_machine
from repro.core import sim as ref_sim
from repro_torch.core import machine, sim
from repro_torch.launch import gups, kernel_bench

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _same_machine(name="h100"):
    mm = machine.set_machine(name)
    ref_machine.set_machine(ref_machine.MachineModel(**dataclasses.asdict(mm)))
    return mm


def _load(relpath: str):
    """A reference script as a module (its main() runs only when called)."""
    if str(ROOT) not in sys.path:              # benchmarks.common
        sys.path.insert(0, str(ROOT))
    path = ROOT / relpath
    spec = importlib.util.spec_from_file_location(
        "ref_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue().splitlines()


# Not the far-memory profiles: their 64-256 request slots let the scatter
# solve past the 28 RMW tiles one H100 block's shared memory holds, a clamp
# the TPU reference does not have.
@pytest.mark.parametrize("profile", ["h100", "cpu-interpret"])
def test_gups_example_matches_reference(profile):
    _same_machine(profile)
    res, lines = _stdout(gups.main, ["--device", "cpu"])
    _, ref_lines = _stdout(_load("examples/gups_coro.py").main)
    # every line but the telemetry dump (the reference's has its guard
    # counters) is the same text: depths, context bytes, coalescing ratio,
    # depth solve and the model's speedups
    strip = [line for line in lines if not line.startswith("telemetry:")]
    ref_strip = [line for line in ref_lines if not line.startswith("telemetry:")]
    assert strip == ref_strip
    assert len(strip) == 9
    assert res["depths"]["row_gather"][0] >= 1
    assert res["coalescing"][0] == 256


def test_gups_round_matches_reference_values():
    """The default run's gathered rows and updated table, value by value."""
    import jax.numpy as jnp
    from repro.kernels.coro_gather.ops import coro_gather as ref_gather
    from repro.kernels.coro_scatter_add.ops import coro_scatter_add as ref_sa

    rng = np.random.RandomState(0)
    table = rng.randn(1024, 128).astype(np.float32)
    idx = rng.randint(0, 1024, 256).astype(np.int32)
    upd = (rng.randn(256, 128) * 0.1).astype(np.float32)
    res, _ = _stdout(gups.gups_example, torch.device("cpu"))
    np.testing.assert_array_equal(
        res["gathered"].numpy(),
        np.asarray(ref_gather(jnp.asarray(table), jnp.asarray(idx))))
    np.testing.assert_allclose(
        res["updated"].numpy(),
        np.asarray(ref_sa(jnp.asarray(table), idx, jnp.asarray(upd))),
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("profile", ["h100", "v5e", "v5e-far-800ns"])
def test_smoke_record_matches_machine_smoke(profile):
    _same_machine(profile)
    rec, lines = _stdout(gups.main, ["--device", "cpu", "--smoke"])
    _, ref_lines = _stdout(_load("scripts/machine_smoke.py").main)
    ref = json.loads(ref_lines[-1])
    assert json.loads(lines[-1]) == rec
    assert {k: rec[k] for k in ref} == ref
    assert rec["device"] == "cpu"


def test_gups_round_times_only_the_kernel_calls(monkeypatch):
    """The transfer samples time the two kernel calls alone: the host dedup
    and padding run before the timed call, never inside it."""
    from repro_torch.kernels.coro_gather.coro_gather import row_gather
    from repro_torch.kernels.coro_scatter_add import ops as scatter_ops
    from repro_torch.kernels.coro_scatter_add.coro_scatter_add import (
        scatter_add_unique,
    )

    timed, inside = [], [False]

    def record(kernel, n_tiles, fn, *args, **kw):
        timed.append((kernel, n_tiles, fn))
        inside[0] = True
        try:
            return fn(*args, **kw)
        finally:
            inside[0] = False

    dedup = scatter_ops.dedup_rmw

    def checked_dedup(*args):
        assert not inside[0], "the dedup ran inside a timed kernel call"
        return dedup(*args)

    monkeypatch.setattr(gups, "observed", record)
    monkeypatch.setattr(scatter_ops, "dedup_rmw", checked_dedup)
    rng = np.random.RandomState(1)
    table = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    idx = rng.randint(0, 64, 21).astype(np.int32)
    upd = torch.from_numpy(rng.randn(21, 8).astype(np.float32))
    gathered, updated = gups.gups_round(table, idx, upd)
    n_unique = len(np.unique(idx))
    assert timed == [("row_gather", 3, row_gather),
                     ("scatter_add", -(-n_unique // 8), scatter_add_unique)]
    assert torch.equal(gathered, table[torch.from_numpy(idx).long()])
    want = table.clone().index_put_((torch.from_numpy(idx).long(),), upd,
                                    accumulate=True)
    torch.testing.assert_close(updated, want, rtol=2e-3, atol=2e-3)


def test_far_profile_solves_deeper():
    """The latency dial reaches the solver: 800 ns of far memory needs a
    deeper row-gather pipeline than local HBM (the reference's CI lane)."""
    machine.set_machine("v5e")
    near = gups.machine_smoke("cpu")["solved_depth"]
    machine.set_machine("v5e-far-800ns")
    far = gups.machine_smoke("cpu")["solved_depth"]
    assert far > near


@pytest.mark.parametrize("entry", ["gups", "gups_smoke", "kernel_bench"])
def test_launchers_raise_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the launchers run on it")
    main, argv = {"gups": (gups.main, []),
                  "gups_smoke": (gups.main, ["--smoke"]),
                  "kernel_bench": (kernel_bench.main, [])}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_kernel_bench_rows_match_reference():
    _same_machine()
    ref = _load("benchmarks/kernel_bench.py")
    assert kernel_bench.coalesce_rows() == ref.coalesce_rows()
    assert kernel_bench.schedule_rows() == ref.schedule_rows()
    ref_ctx = {row[0]: row for row in ref.context_rows()}
    rows = kernel_bench.context_rows()
    assert [r[0] for r in rows] == ["row_gather", "scatter_add",
                                    "stream_triad"]
    for row in rows:
        assert row == ref_ctx[row[0]]
    cpu = torch.device("cpu")
    got = kernel_bench.gather_rows(cpu) + kernel_bench.triad_rows(cpu)
    want = ref.gather_rows() + ref.triad_rows()
    # name, shape, correctness and the depth run; not the host times
    assert [r[:2] + r[3:] for r in got] == [r[:2] + r[3:] for r in want]
    assert all(r[3] is True for r in got)


def test_kernel_bench_table_and_json_on_cpu():
    _, lines = _stdout(kernel_bench.main, ["--device", "cpu"])
    assert lines[0] == "# device: cpu"
    assert "adaptive_depth,row_gather,5" in "\n".join(lines)
    report, _ = _stdout(kernel_bench.main, ["--device", "cpu", "--json"])
    rep = json.loads(report)
    assert set(rep["kernels"]) == {"row_gather", "span_gather", "scatter_add",
                                   "stream_triad"}
    for entry in rep["kernels"].values():
        assert entry["ran_depth"] <= entry["static_depth"]
        assert entry["samples"] == 0        # the CPU feeds no transfer samples


@pytest.mark.parametrize("lat", [100, 200, 400, 800])
def test_sim_matches_reference(lat):
    sim.calibration_check()
    for bench in sim.BENCHES:
        for variant in sim.VARIANTS:
            got = sim.simulate(variant, sim.BENCHES[bench], latency_ns=lat)
            want = ref_sim.simulate(variant, ref_sim.BENCHES[bench],
                                    latency_ns=lat)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for variant in sim.VARIANTS[1:]:
        assert sim.average_speedup(variant, latency_ns=lat) == \
            ref_sim.average_speedup(variant, latency_ns=lat)
