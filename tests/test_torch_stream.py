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
from repro_torch.kernels import launch_counts
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
