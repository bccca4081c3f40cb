"""`launch.serve_batched` (the port of `examples/serve_batched.py`) on the
CPU: its dense demo serves reduced yi-6b, hymba-1.5b and mamba2-130m, its
paged and prefix demos keep their asserts, and the flash-decode line it
prints for each attention arch (solved depth, context bytes, all-private
baseline) is the reference example's under one machine profile.
"""
import dataclasses
import re

import jax.numpy as jnp
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.kernels.decode_attention import decode_attention as ref_da
from repro_torch.core import machine
from repro_torch.launch import serve_batched


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()
    ref_machine.set_machine(None)


def _reference_line(arch):
    """What examples/serve_batched.py:dense_demo prints for `arch`."""
    cfg = ref_get_config(arch).reduced()
    d = cfg.resolved_head_dim
    g = max(cfg.n_heads // cfg.kv_heads, 1)
    spec = ref_da.decode_spec(128, cfg.kv_heads, g, d, jnp.bfloat16)
    depth = ref_autotune.choose_depth(spec.profile(), vars=spec.all_vars())
    return (f"flash-decode spec: depth {depth}, context "
            f"{spec.context_bytes(depth)} B (all-private baseline "
            f"{spec.context_bytes(depth, baseline=True)} B)")


def test_every_demo_runs_on_the_cpu_and_keeps_its_asserts(capsys):
    out = serve_batched.main(["--device", "cpu", "--engine", "both",
                              "--prefix-cache"])
    assert set(out["dense"]) == set(serve_batched.DENSE_ARCHS)
    for arch, r in out["dense"].items():
        assert r["stats"]["generated_shape"] == (4, 12), arch
        assert r["stats"]["device"] == "cpu"
    assert out["paged"]["completed"] == 8
    assert out["paged"]["kv_oversubscription"] >= 2.0
    assert out["prefix"]["prefix_hits"] > 0
    printed = capsys.readouterr().out
    assert printed.count("flash-decode spec:") == 3
    assert "paged yi-6b" in printed and "prefix yi-6b" in printed


@pytest.mark.parametrize("profile", ["v5e", "h100", "v5e-far-800ns"])
def test_flash_decode_lines_equal_the_reference(profile, capsys):
    mm = machine.machine_profile(profile)
    machine.set_machine(mm)
    ref_machine.set_machine(ref_machine.MachineModel(**dataclasses.asdict(mm)))
    serve_batched.dense_demo("cpu")
    lines = [re.sub(r"^\s+", "", ln) for ln in capsys.readouterr().out
             .splitlines() if "flash-decode spec:" in ln]
    assert lines == [_reference_line(a) for a in serve_batched.DENSE_ARCHS]


def test_the_demos_need_a_device_they_can_use():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batched.main(["--engine", "dense"])
