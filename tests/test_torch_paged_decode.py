"""Paged flash-decode in the PyTorch port against the JAX reference.

The port's plain version (what its wrapper runs on CPU tensors) is held to
the reference's Pallas kernel in interpret mode and to the reference's jnp
twin, on the same numpy inputs, at the reference tests' 2e-5 (f32). The
kernel's CoroSpec must give the same context bytes and the same solved
depth as the reference's under one shared MachineModel. The CUDA kernel
itself is checked against the plain version on the card
(`test_torch_kernels_cuda.py`).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.kernels.decode_attention import decode_attention as ref_da
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as ref_paged_op
from repro.models import common as ref_common
from repro_torch.core import autotune, machine
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_attention import decode_attention as da

TOL = 2e-5


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _problem(rng, lengths, *, h, kh, d, blk, extra_blocks=3):
    """Random pools + disjoint shuffled block tables (numpy, float32)."""
    lengths = np.asarray(lengths, np.int32)
    nb_per = [-(-int(n) // blk) for n in lengths]
    m = max(max(nb_per), 1)
    total = sum(nb_per)
    nb = total + 1 + extra_blocks
    q = rng.randn(len(lengths), h, d).astype(np.float32)
    kp = rng.randn(nb, blk, kh, d).astype(np.float32)
    vp = rng.randn(nb, blk, kh, d).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb))[:total]
    bt = np.zeros((len(lengths), m), np.int32)
    off = 0
    for r, n in enumerate(nb_per):
        bt[r, :n] = ids[off:off + n]
        off += n
    return q, kp, vp, bt, lengths


def _port(q, kp, vp, bt, lens, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, kp, vp, bt, lens)]
    return da.paged_flash_decode(*t, **kw).numpy()


def _twin(q, kp, vp, bt, lens):
    out = ref_common.paged_decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(lens))
    return np.asarray(out[:, 0])


def _pallas(q, kp, vp, bt, lens, depth=None):
    return np.asarray(ref_paged_op(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(bt),
                                   jnp.asarray(lens), depth=depth,
                                   interpret=True))


def test_plain_matches_pallas_and_twin_on_ragged_lengths():
    rng = np.random.RandomState(0)
    prob = _problem(rng, [16, 40, 128], h=8, kh=2, d=16, blk=16)
    out = _port(*prob)
    np.testing.assert_allclose(out, _pallas(*prob), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, _twin(*prob), rtol=TOL, atol=TOL)
    assert launch_counts()["paged_decode"] == 0   # CPU tensors: plain path


def test_plain_depths_and_zero_length_padding_row():
    """Depth sweep + a zero-length padding slot on the garbage page: real
    rows match the reference kernel, the padding row is finite."""
    rng = np.random.RandomState(1)
    q, kp, vp, bt, lens = _problem(rng, [32, 8, 0], h=4, kh=2, d=16, blk=8)
    bt[2] = 0
    ref = _twin(q, kp, vp, bt, lens)
    for depth in (1, 2, 5):
        out = _port(q, kp, vp, bt, lens, depth=depth)
        np.testing.assert_allclose(out[:2], ref[:2], rtol=TOL, atol=TOL)
        assert np.isfinite(out).all()
    pal = _pallas(q, kp, vp, bt, lens, depth=2)
    np.testing.assert_allclose(_port(q, kp, vp, bt, lens)[:2], pal[:2],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kh,h,blk", [(2, 8, 16), (1, 4, 32), (4, 4, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_ragged_sweep(kh, h, blk, seed):
    """Random length mixes with >= 4x spread, against the jnp twin (and the
    Pallas kernel for one case: each interpret-mode call costs seconds)."""
    rng = np.random.RandomState(100 + seed)
    base = int(rng.randint(1, 2 * blk))
    lengths = sorted(rng.randint(base, 8 * base + 1, size=4).tolist())
    lengths[0], lengths[-1] = base, max(lengths[-1], 4 * base)
    prob = _problem(rng, lengths, h=h, kh=kh, d=16, blk=blk)
    out = _port(*prob)
    np.testing.assert_allclose(out, _twin(*prob), rtol=TOL, atol=TOL)
    if seed == 0 and kh == 2:
        np.testing.assert_allclose(out, _pallas(*prob), rtol=TOL, atol=TOL)


def test_plain_keeps_bf16_and_masks_past_the_table():
    """Output keeps q's type; lengths past the table attend the whole
    table, as the reference's masked walk does."""
    rng = np.random.RandomState(3)
    q, kp, vp, bt, lens = _problem(rng, [20, 9], h=4, kh=2, d=16, blk=8)
    long = np.array([1000, 9], np.int32)
    out = _port(q, kp, vp, bt, long)
    np.testing.assert_allclose(out, _twin(q, kp, vp, bt, long), rtol=TOL,
                               atol=TOL)
    tq = torch.from_numpy(q).bfloat16()
    res = da.paged_flash_decode(tq, torch.from_numpy(kp).bfloat16(),
                                torch.from_numpy(vp).bfloat16(),
                                torch.from_numpy(bt), torch.from_numpy(lens))
    assert res.dtype == torch.bfloat16 and res.shape == tq.shape


def test_wrapper_rejects_bad_inputs():
    rng = np.random.RandomState(4)
    q, kp, vp, bt, lens = (torch.from_numpy(a) for a in
                           _problem(rng, [5, 9], h=4, kh=2, d=16, blk=8))
    with pytest.raises(ValueError):
        da.paged_flash_decode(q, kp, vp, bt, lens, depth=0)
    with pytest.raises(ValueError):
        da.paged_flash_decode(q[:, :3], kp, vp, bt, lens)   # H % KH != 0
    with pytest.raises(ValueError):
        da.paged_flash_decode(q, kp, vp, bt[:1], lens)
    with pytest.raises(ValueError):
        da.paged_flash_decode(q, kp, vp[:, :4], bt, lens)


def test_kernel_depth_clamps_to_shared_memory_and_tiles():
    # yi-6b bf16 page pair: 8 KB per slot -> 27 slots fit beside the tile
    assert da.kernel_depth(64, g=8, d=128, blk=16, itemsize=2,
                           n_tiles=100) == 27
    assert da.kernel_depth(64, g=8, d=128, blk=16, itemsize=2, n_tiles=18) == 18
    assert da.kernel_depth(3, g=2, d=16, blk=8, itemsize=4, n_tiles=10) == 3
    with pytest.raises(ValueError):
        da.kernel_depth(0, g=2, d=16, blk=8, itemsize=4, n_tiles=10)


@pytest.mark.parametrize("profile", ["v5e", "cpu-interpret", "h100"])
@pytest.mark.parametrize("blk,kh,g,d,dtype", [
    (16, 4, 8, 128, "bfloat16"),     # yi-6b
    (16, 8, 4, 64, "bfloat16"),      # granite-3-2b
    (16, 2, 2, 16, "float32"),       # reduced yi-6b
])
def test_spec_context_and_depth_match_reference(profile, blk, kh, g, d, dtype):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    spec = da.paged_decode_spec(blk, kh, g, d, getattr(torch, dtype),
                                max_blocks=64)
    ref_spec = ref_da.paged_decode_spec(blk, kh, g, d, jnp.dtype(dtype),
                                        max_blocks=64)
    for depth in (1, 2, 7):
        assert spec.context_bytes(depth) == ref_spec.context_bytes(depth)
        assert spec.context_bytes(depth, baseline=True) == \
            ref_spec.context_bytes(depth, baseline=True)
    assert spec.profile() == type(spec.profile())(
        **dataclasses.asdict(ref_spec.profile()))
    got = autotune.choose_depth(spec.profile(), machine=mm,
                                vars=spec.all_vars())
    want = ref_autotune.choose_depth(ref_spec.profile(), machine=ref_mm,
                                     vars=ref_spec.all_vars())
    assert got == want
