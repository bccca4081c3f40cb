"""The port's Fig. 14 stall breakdown (`obs.breakdown`) against the JAX
reference's, on the same recorded samples and tile profiles under one
machine profile, and the breakdown `telemetry_summary` carries for a live
paged decode on the CPU (the scenarios of ``tests/test_obs.py``)."""
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.core import schedule as ref_schedule
from repro.obs import breakdown as ref_breakdown
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import autotune, machine
from repro_torch.core.schedule import TileProfile, tile_compute_s
from repro_torch.obs import breakdown
from repro_torch.serve import PagedServingEngine

PROFILES = ("v5e", "v5e-far-800ns", "nh-g")


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _profiles(tile_bytes, flops):
    return (TileProfile(tile_bytes=tile_bytes, flops_per_tile=flops),
            ref_schedule.TileProfile(tile_bytes=tile_bytes,
                                     flops_per_tile=flops))


@pytest.mark.parametrize("profile", PROFILES)
def test_attribute_matches_reference(profile):
    machine.set_machine(profile)
    ref_machine.set_machine(profile)
    for tile, flops in ((1 << 20, 1e6), (1024, 1e9), (1 << 14, 0.0)):
        p, rp = _profiles(tile, flops)
        for depth in (None, 1, 2, 8, 64):
            for w in (0.0, 1e-6, 5e-5, 3e-3):
                assert breakdown.attribute(p, depth, w) == \
                    ref_breakdown.attribute(rp, depth, w)


def test_attribution_sums_to_observed():
    p = TileProfile(tile_bytes=1 << 20, flops_per_tile=1e6)
    for depth in (1, 2, 8, 64):
        for w in (1e-6, 5e-5, 3e-3):
            bd = breakdown.attribute(p, depth, w)
            total = bd["compute_us"] + bd["transfer_us"] + bd["gap_us"]
            assert total == pytest.approx(bd["observed_us"], rel=0.1)
    heavy = TileProfile(tile_bytes=1024, flops_per_tile=1e9)
    bd = breakdown.attribute(heavy, 64, tile_compute_s(heavy) * 1.01)
    assert bd["compute_frac"] > 0.9


@pytest.mark.parametrize("profile", PROFILES)
def test_stall_breakdown_matches_reference(profile):
    """The same choose_depth calls and recorded samples in both packages
    give the same telemetry breakdowns and the same Fig. 14 report, the
    unattributed kernel included."""
    machine.set_machine(profile)
    ref_machine.set_machine(profile)
    rng = np.random.RandomState(5)
    for name, tile, flops in (("bdk", 1 << 16, 1e5), ("gather", 8 * 512, 4e3),
                              ("matmul", 1 << 18, 1e9)):
        p, rp = _profiles(tile, flops)
        assert autotune.choose_depth(p, kernel=name) == \
            ref_autotune.choose_depth(rp, kernel=name)
        assert autotune.last_profile(name) == p
        for s in rng.uniform(1e-6, 1e-3, 9):
            autotune.record_transfer(name, float(s))
            ref_autotune.record_transfer(name, float(s))
    autotune.record_transfer("no_profile_kernel", 1e-4)
    ref_autotune.record_transfer("no_profile_kernel", 1e-4)
    got, want = obs.stall_breakdown(), ref_breakdown.stall_breakdown()
    assert got == want
    assert got["kernels"]["no_profile_kernel"]["unattributed"] is True
    summ = autotune.telemetry_summary()
    ref_summ = ref_autotune.telemetry_summary()
    for name in ("bdk", "gather", "matmul"):
        assert summ["kernels"][name]["breakdown"] == \
            ref_summ["kernels"][name]["breakdown"] == got["kernels"][name]


def _pressured_prefix_run():
    """A paged run with a shared system prefix diverging mid-block and a
    pool tight enough to reclaim and preempt (test_obs.py's run)."""
    cfg = get_config("yi-6b").reduced().replace(dtype="float32",
                                                param_dtype="float32")
    rng = np.random.default_rng(3)
    shared = list(rng.integers(0, cfg.vocab, 6))  # 1.5 blocks at blk=4
    prompts = [shared + list(rng.integers(0, cfg.vocab, 18 + 3 * i))
               for i in range(3)]
    eng = PagedServingEngine(cfg, block_size=4, num_blocks=14,
                             prefix_cache=True, device="cpu")
    for p in prompts:
        eng.submit(p, max_new_tokens=4)
    return eng, eng.run()


def test_breakdown_sums_for_live_paged_decode():
    """The breakdown the engine's decode rounds produce sums to their
    observed per-tile wall time, and the report lists it."""
    _eng, stats = _pressured_prefix_run()
    entry = autotune.telemetry_summary()["kernels"]["paged_decode"]
    assert entry["samples"] > 0
    bd = entry["breakdown"]
    assert bd["depth"] == autotune.last_choice("paged_decode")
    total = bd["compute_us"] + bd["transfer_us"] + bd["gap_us"]
    assert total == pytest.approx(bd["observed_us"], rel=0.1)
    assert bd["observed_us"] == pytest.approx(entry["p50_us"], rel=1e-6)
    assert obs.stall_breakdown()["kernels"]["paged_decode"] == bd
    assert stats["substrate"]["parity_mismatches"] == 0
