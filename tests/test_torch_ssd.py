"""The SSD scan (K4) and the Mamba-2 block in the PyTorch port against the
JAX reference.

The port's plain K4 (what `ssd_scan` runs on CPU tensors) is held to the
reference's Pallas kernel in interpret mode at the reference tests' shapes
and tolerance (3e-4: a chunked f32 scan against a sequential one); the
port's `ssd_chunked` (with an initial state, and off the chunk, where it
is the sequential recurrence), `ssd_sequential`, `ssm_forward` (with
`return_state` and `conv0`) and `ssm_decode` to the reference's at 2e-3
(f32); `profile_ssd` and the `ssd_spec` solve equal the reference's under
one profile. Inputs come from numpy with a seed. The CUDA kernel is checked
against the plain version on the card (`test_torch_kernels_cuda.py`).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.kernels.ssd_scan import ssd_scan as ref_ss
from repro.kernels.ssd_scan.ops import ssd as ref_ssd
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.core import autotune, machine
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan import ssd_scan as ss
from repro_torch.models import ssm

TOL = 3e-4
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _inputs(seed, b, s, nh, p, n):
    """The reference test's draws: dt in [0.1, 0.6), A = -exp(0.3 N)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, nh, p).astype(np.float32),
            (rng.rand(b, s, nh) * 0.5 + 0.1).astype(np.float32),
            (-np.exp(rng.randn(nh) * 0.3)).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_matches_pallas(chunk):
    args = _inputs(chunk, 2, 128, 3, 8, 16)
    y, hf = ss.ssd_scan(*_t(args), chunk=chunk)
    ry, rh = ref_ssd(*_j(args), chunk=chunk, interpret=True)
    _close(y.numpy(), ry, TOL)
    _close(hf.numpy(), rh, TOL)
    assert hf.dtype == torch.float32
    assert launch_counts()["ssd_scan"] == 0          # CPU tensors: plain path


@pytest.mark.parametrize("nh,p,n", [(1, 4, 8), (4, 16, 32)])
def test_plain_shape_sweep(nh, p, n):
    args = _inputs(nh + p, 1, 64, nh, p, n)
    y, hf = ops.ssd(*_t(args), chunk=16)
    ry, rh = ref_ssd(*_j(args), chunk=16, interpret=True)
    _close(y.numpy(), ry, TOL)
    _close(hf.numpy(), rh, TOL)


def test_plain_keeps_x_type():
    x, dt, A, B, C = _t(_inputs(1, 1, 32, 2, 8, 16))
    y, hf = ss.ssd_scan(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                        chunk=16)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32


def test_strong_decay_stays_finite():
    """dt 8 and A -1 over 16-row chunks: a chunk's decay reaches 128, past
    where exp of the upper triangle overflows. Masked before the exponent,
    the plain version stays finite and matches the sequential recurrence."""
    rng = np.random.RandomState(11)
    b, s, nh, p, n = 2, 64, 2, 8, 16
    x = rng.randn(b, s, nh, p).astype(np.float32)
    dt = np.full((b, s, nh), 8.0, np.float32)
    A = np.full((nh,), -1.0, np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    y, hf = ss.ssd_scan(*_t((x, dt, A, B, C)), chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    sy, sh = ssm.ssd_sequential(*_t((x, dt, A, B, C)))
    _close(y.numpy(), sy.numpy(), 2e-3)
    _close(hf.numpy(), sh.numpy(), 2e-3)
    ry, rh = ref_ssm.ssd_sequential(*_j((x, dt, A, B, C)))
    _close(sy.numpy(), ry, 2e-3)


def test_ssd_chunked_with_initial_state_matches_reference():
    x, dt, A, B, C = _inputs(5, 2, 64, 3, 8, 16)
    h0 = np.random.RandomState(6).randn(2, 3, 8, 16).astype(np.float32)
    y, hf = ssm.ssd_chunked(*_t((x, dt, A, B, C)), 16,
                            h0=torch.from_numpy(h0))
    ry, rh = ref_ssm.ssd_chunked(*_j((x, dt, A, B, C)), 16,
                                 h0=jnp.asarray(h0))
    _close(y.numpy(), ry, 2e-3)
    _close(hf.numpy(), rh, 2e-3)
    assert autotune.last_choice("ssd_scan") is None   # not the kernel's path


def test_ssd_chunked_off_the_chunk_is_the_recurrence():
    args = _inputs(7, 2, 40, 2, 8, 16)           # 40 % 16 != 0
    y, hf = ssm.ssd_chunked(*_t(args), 16)
    ry, rh = ref_ssm.ssd_chunked(*_j(args), 16)
    _close(y.numpy(), ry, 2e-3)
    _close(hf.numpy(), rh, 2e-3)
    sy, sh = ssm.ssd_sequential(*_t(args))
    np.testing.assert_array_equal(y.numpy(), sy.numpy())
    assert autotune.last_choice("ssd_scan") is None


def test_ssd_chunked_on_a_zero_state_takes_the_kernel_route():
    args = _inputs(8, 1, 64, 2, 8, 16)
    y, _ = ssm.ssd_chunked(*_t(args), 16)
    assert autotune.last_choice("ssd_scan") is not None
    ry, _ = ref_ssm.ssd_chunked(*_j(args), 16)
    _close(y.numpy(), ry, 2e-3)


@pytest.mark.parametrize("h0", [False, True])
def test_ssd_sequential_matches_reference(h0):
    args = _inputs(9, 2, 24, 2, 4, 8)
    state = np.random.RandomState(10).randn(2, 2, 4, 8).astype(np.float32)
    y, hf = ssm.ssd_sequential(*_t(args),
                               h0=torch.from_numpy(state) if h0 else None)
    ry, rh = ref_ssm.ssd_sequential(*_j(args),
                                    h0=jnp.asarray(state) if h0 else None)
    _close(y.numpy(), ry, 2e-3)
    _close(hf.numpy(), rh, 2e-3)


def _ssm_layer(seed=0):
    """Layer 0's SSM parameters of reduced mamba2-130m, from the
    reference's init, in both packages."""
    ref_cfg = ref_get_config("mamba2-130m").reduced().replace(**F32)
    cfg = get_config("mamba2-130m").reduced().replace(**F32)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(seed))
    ref_p = jax.tree.map(lambda a: a[0], ref_params["layers"]["ssm"])
    # random A_log, dt_bias and D: the init's zeros/ones hide mistakes
    rng = np.random.RandomState(seed + 1)
    ref_p = dict(ref_p)
    for k in ("A_log", "dt_bias", "D", "conv_b"):
        ref_p[k] = jnp.asarray(rng.randn(*ref_p[k].shape) * 0.5, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return ref_cfg, cfg, ref_p, p


@pytest.mark.parametrize("s", [32, 24])   # on the chunk (K4), and off it
@pytest.mark.parametrize("with_conv0", [False, True])
def test_ssm_forward_matches_reference(s, with_conv0):
    ref_cfg, cfg, ref_p, p = _ssm_layer()
    rng = np.random.RandomState(s)
    x = (rng.randn(2, s, cfg.d_model) * 0.5).astype(np.float32)
    conv_dim = ssm.ssm_dims(cfg)["conv_dim"]
    conv0 = (rng.randn(2, cfg.conv_width - 1, conv_dim).astype(np.float32)
             if with_conv0 else None)
    out, hf, conv = ssm.ssm_forward(
        p, torch.from_numpy(x), cfg, return_state=True,
        conv0=None if conv0 is None else torch.from_numpy(conv0))
    rout, rhf, rconv = ref_ssm.ssm_forward(
        ref_p, jnp.asarray(x), ref_cfg, return_state=True,
        conv0=None if conv0 is None else jnp.asarray(conv0))
    _close(out.numpy(), rout, 2e-3)
    _close(hf.numpy(), rhf, 2e-3)
    _close(conv.numpy(), rconv, 2e-3)
    plain = ssm.ssm_forward(p, torch.from_numpy(x), cfg,
                            conv0=None if conv0 is None
                            else torch.from_numpy(conv0))
    _close(plain.numpy(), rout, 2e-3)


def test_ssm_decode_matches_reference():
    ref_cfg, cfg, ref_p, p = _ssm_layer(3)
    rng = np.random.RandomState(4)
    d = ssm.ssm_dims(cfg)
    shapes = ssm.ssm_cache_shape(cfg, 3)
    assert shapes == ref_ssm.ssm_cache_shape(ref_cfg, 3)
    h = rng.randn(*shapes["h"][0]).astype(np.float32)
    conv = rng.randn(3, cfg.conv_width - 1, d["conv_dim"]).astype(np.float32)
    x = (rng.randn(3, 1, cfg.d_model) * 0.5).astype(np.float32)
    out, st = ssm.ssm_decode(p, {"h": torch.from_numpy(h),
                                 "conv": torch.from_numpy(conv)},
                             torch.from_numpy(x), cfg)
    rout, rst = ref_ssm.ssm_decode(ref_p, {"h": jnp.asarray(h),
                                           "conv": jnp.asarray(conv)},
                                   jnp.asarray(x), ref_cfg)
    _close(out.numpy(), rout, 2e-3)
    _close(st["h"].numpy(), rst["h"], 2e-3)
    _close(st["conv"].numpy(), rst["conv"], 2e-3)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_ssm_dims_and_specs_match_reference(arch, reduced):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    assert ssm.ssm_dims(cfg) == ref_ssm.ssm_dims(ref_cfg)
    ours = ssm.ssm_param_specs(cfg)
    ref = ref_ssm.ssm_param_specs(ref_cfg)
    assert set(ours) == set(ref)
    for k, s in ours.items():
        assert (s.shape, s.axes, s.init) == (ref[k].shape, ref[k].axes,
                                             ref[k].init)
    # the split training layout: the reference's specs; decode refuses it
    split = ssm.ssm_param_specs(cfg.replace(ssm_split_proj=True))
    ref_split = ref_ssm.ssm_param_specs(ref_cfg.replace(ssm_split_proj=True))
    assert set(split) == set(ref_split)
    for k, s in split.items():
        assert (s.shape, s.axes, s.init) == (ref_split[k].shape,
                                             ref_split[k].axes,
                                             ref_split[k].init)
    meta = {k: torch.empty(s.shape, device="meta") for k, s in split.items()}
    with pytest.raises(NotImplementedError, match="joint in_proj layout"):
        ssm.ssm_decode(meta, {}, torch.empty(1, 1, cfg.d_model,
                                             device="meta"), cfg)


@pytest.mark.parametrize("args", [(256, 24, 64, 128, 2, 2048),
                                  (64, 8, 64, 128, 4, 2048),
                                  (16, 8, 16, 16, 4, None)])
def test_profile_ssd_matches_reference(args):
    *pos, seq_len = args
    assert dataclasses.asdict(autotune.profile_ssd(*pos, seq_len=seq_len)) \
        == dataclasses.asdict(ref_autotune.profile_ssd(*pos, seq_len=seq_len))


@pytest.mark.parametrize("profile", ["v5e", "cpu-interpret", "h100"])
@pytest.mark.parametrize("chunk,nh,p,n,dtype,seq_len", [
    (256, 24, 64, 128, "bfloat16", 2048),    # mamba2-130m's prefill
    (256, 50, 64, 16, "bfloat16", 2048),     # hymba-1.5b's widths
    (64, 8, 64, 128, "float32", 2048),       # kernel_bench's context row
    (64, 2, 8, 16, "float32", 128),          # kernel_bench's --json workload
    (16, 8, 16, 16, "float32", 64),          # reduced mamba2
])
def test_spec_context_and_depth_match_reference(profile, chunk, nh, p, n,
                                                dtype, seq_len):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    spec = ss.ssd_spec(chunk, nh, p, n, getattr(torch, dtype),
                       seq_len=seq_len)
    ref_spec = ref_ss.ssd_spec(chunk, nh, p, n, jnp.dtype(dtype),
                               seq_len=seq_len)
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


def test_mamba2_solve_falls_to_the_floor_and_the_kernel_runs_what_fits():
    """At mamba2's prefill shape the reference spec's y_block resident
    (seq_len x nh x p x 2 B = 6 MiB) is over a block's shared memory, so
    the solve is the floor (2); the kernel's depth (heads' tiles in flight
    a block) is what fits beside C, C B^T and a head's decayed scores (one
    slot at mamba2's widths), and at most a group's heads."""
    spec = ss.ssd_spec(256, 24, 64, 128, torch.bfloat16, seq_len=2048)
    solved = autotune.choose_depth(spec.profile(),
                                   machine=machine.machine_profile("h100"),
                                   vars=spec.all_vars())
    assert solved == 2
    fit = (ring.SMEM_LIMIT - ss.fixed_bytes(64, 128, 2)) // \
        ss.slot_bytes(64, 128, 2)
    assert fit == 1
    assert ss.kernel_depth(64, p=64, n=128, itemsize=2, n_tiles=6) == fit
    assert ss.kernel_depth(solved, p=64, n=128, itemsize=2, n_tiles=6) == 1
    assert ss.kernel_depth(64, p=64, n=128, itemsize=4, n_tiles=6) == 2
    assert ss.kernel_depth(solved, p=16, n=16, itemsize=2, n_tiles=6) == 2
    assert ss.kernel_depth(64, p=16, n=16, itemsize=4, n_tiles=6) == 6
    assert ss.kernel_depth(64, p=16, n=16, itemsize=4, n_tiles=1) == 1
    with pytest.raises(ValueError):
        ss.kernel_depth(0, p=64, n=128, itemsize=2, n_tiles=3)


def test_slot_layout_follows_the_kernel_source():
    src = Path(ss.SOURCE).read_text()
    assert f"static constexpr int kL = {ss.CHUNK[torch.bfloat16]};" in src
    assert f"static constexpr int kL = {ss.CHUNK[torch.float32]};" in src
    assert f"constexpr int kMaxState = {ss.MAX_STATE};" in src
    assert f"constexpr int kMaxHead = {ss.MAX_HEAD};" in src
    assert '#include "../../csrc/coro_ring.cuh"' in src
    for text in ("xs = tc ? Pp + 8 : P;", "bs = tc ? Np + 8 : N;",
                 "hs = tc ? Np + 12 : N;",
                 "cbs = L + (tc ? 8 : 4);",
                 "vec = static_cast<size_t>(3 * L + 8) * 4;",
                 "return (tc ? 1 : 2) * bc + 2 * cb + vec;",
                 "return x + h + dtw;"):
        assert text in src
    # bf16: x [128][72] bf16, state [64][140] f32, dt; C [128][136] bf16,
    # C B^T [128][136] f32, the scores' two parts [128][136] bf16, three
    # [128] f32 vectors and 8 words of scratch
    assert ss.slot_bytes(64, 128, 2) == 128 * 72 * 2 + 64 * 140 * 4 + 128 * 4
    assert ss.fixed_bytes(64, 128, 2) == (128 * 136 * 2 + 2 * 128 * 136 * 4
                                          + (3 * 128 + 8) * 4)
    # f32: x [64][64], state [64][128], dt; C and B [64][128], C B^T and
    # the decayed scores [64][68], three [64] vectors, 8 words
    assert ss.slot_bytes(64, 128, 4) == 64 * 64 * 4 + 64 * 128 * 4 + 64 * 4
    assert ss.fixed_bytes(64, 128, 4) == (2 * 64 * 128 * 4 + 2 * 64 * 68 * 4
                                          + (3 * 64 + 8) * 4)
    # the reduced shape: p and n padded to 16 in bf16
    assert ss.slot_bytes(8, 4, 2) == 128 * 24 * 2 + 16 * 28 * 4 + 128 * 4


@pytest.mark.parametrize("b,s,nh,p,n,itemsize,chunks,groups", [
    (8, 2048, 24, 64, 128, 2, 16, 2),     # mamba2-130m's prefill
    (2, 4096, 24, 64, 128, 2, 32, 2),
    (2, 512, 50, 64, 16, 2, 4, 5),        # hymba: the last group of 2 heads
    (2, 256, 8, 16, 32, 2, 2, 1),         # 8 heads: one group of 8
    (2, 48, 8, 16, 16, 2, 1, 1),          # s off the chunk
    (2, 192, 4, 16, 32, 2, 2, 1),
    (2, 64, 8, 16, 16, 4, 1, 1),          # reduced mamba2 in f32
    (8, 2048, 24, 64, 128, 4, 32, 2)])
def test_plan_chunks_groups_workspace_and_launches(b, s, nh, p, n, itemsize,
                                                   chunks, groups):
    run = ss.plan(b, s, nh, p, n, itemsize, 2)
    assert run.chunk == (128 if itemsize == 2 else 64)
    assert run.chunks == chunks == -(-s // run.chunk)
    assert run.group == min(ss.HEAD_GROUP, nh) and run.groups == groups
    assert (run.groups - 1) * run.group < nh <= run.groups * run.group
    assert run.depth == ss.kernel_depth(2, p=p, n=n, itemsize=itemsize,
                                        n_tiles=run.group)
    assert 1 <= run.depth <= min(2, run.group)
    assert run.workspace_bytes == ss.workspace_bytes(b, s, nh, p, n,
                                                     itemsize)
    assert run.workspace_bytes == 4 * b * chunks * nh * (p * n + 1)
    assert run.launches == ss.LAUNCHES == 3
    if (b, s, nh, p, n, itemsize) == (8, 2048, 24, 64, 128, 2):
        assert run.workspace_bytes == 100_675_584    # ~101 MB, 3072 items
        assert run.chunks * run.groups * b == 256      # blocks a kernel
    one = ss.plan(b, s, nh, p, n, itemsize, 2, group=1)
    assert one.groups == nh and one.depth == 1
    six = ss.plan(b, s, nh, p, n, itemsize, 2, group=6)   # nh 50, 8: off 6
    assert six.groups == -(-nh // 6) and six.group == min(6, nh)
    with pytest.raises(ValueError):
        ss.plan(b, s, nh, p, n, itemsize, 2, group=0)


def _hi_lo(t):
    """t as a bf16 high part and the bf16 part of what it leaves (f32)."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _emulate(x, dt, A, B, C, L, group, split):
    """The kernel's three passes in torch, over chunks of L rows and groups
    of heads: each chunk's state S_c into a workspace, the pass along the
    chunks, then y = intra + inter through C B^T (computed once a group).
    `split` multiplies each operand that carries an f32 factor (x w, the
    decayed scores, the state) as bf16 high and low parts, as the tensor-
    core path does."""
    b, s, nh, p = x.shape
    n = B.shape[2]
    chunks = -(-s // L)
    pad = chunks * L - s
    xc = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)) \
        .view(b, chunks, L, nh, p)
    dtc = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad)) \
        .view(b, chunks, L, nh)
    bc, cc = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
              .view(b, chunks, L, n) for t in (B, C))

    def prod(eq, f32_operand, exact):
        if not split:
            return torch.einsum(eq, f32_operand, exact)
        hi, lo = _hi_lo(f32_operand)
        return torch.einsum(eq, hi, exact) + torch.einsum(eq, lo, exact)

    ys = torch.zeros(b, chunks, L, nh, p)
    work = torch.zeros(b, chunks, nh, p, n)
    totals = torch.zeros(b, chunks, nh)
    for h0 in range(0, nh, group):
        hs = slice(h0, min(h0 + group, nh))
        cs = torch.cumsum(dtc[..., hs] * A[hs], dim=2)       # [b, c, L, g]
        totals[..., hs] = cs[:, :, -1]
        w = torch.exp(cs[:, :, -1:] - cs) * dtc[..., hs]
        work[:, :, hs] = prod("bcjgp,bcjn->bcgpn", xc[..., hs, :]
                              * w[..., None], bc)
    h = torch.zeros(b, nh, p, n)
    for c in range(chunks):                                   # the pass
        s_c = work[:, c].clone()
        work[:, c] = h
        h = h * torch.exp(totals[:, c])[..., None, None] + s_c
    causal = torch.ones(L, L).tril().bool()
    for h0 in range(0, nh, group):
        hs = slice(h0, min(h0 + group, nh))
        cb = torch.einsum("bcin,bcjn->bcij", cc, bc)          # once a group
        cs = torch.cumsum(dtc[..., hs] * A[hs], dim=2)
        seg = cs[:, :, :, None] - cs[:, :, None, :]           # [b,c,i,j,g]
        decay = torch.where(causal[..., None], torch.exp(
            torch.where(causal[..., None], seg, 0.0)), 0.0)
        scores = cb[..., None] * decay * dtc[..., hs][:, :, None]
        intra = prod("bcijg,bcjgp->bcigp", scores, xc[..., hs, :])
        inter = prod("bcgpn,bcin->bcigp", work[:, :, hs], cc) \
            * torch.exp(cs)[..., None]
        ys[..., hs, :] = intra + inter
    return ys.view(b, chunks * L, nh, p)[:, :s].to(x.dtype), h


@pytest.mark.parametrize("L,group,split,s,nh", [
    (128, 6, True, 256, 8),     # bf16's chunk, groups of 6 and 2, split
    (128, 6, True, 192, 3),     # s off the chunk
    (64, 6, False, 128, 8),     # f32's chunk
    (64, 3, False, 48, 4),
    (16, 2, True, 64, 5)])
def test_emulated_chunk_parallel_scan_matches_plain_and_reference(
        L, group, split, s, nh):
    """The kernel's decomposition (its chunk, head groups, workspace pass
    and, for bf16, the high/low split) against the plain version at the
    caller's chunk and the reference's Pallas kernel in interpret mode;
    bf16-valued x, B and C where split, as the kernel gets them."""
    args = _inputs(L + s + nh, 2, s, nh, 16, 32)
    if split:
        args = [a if i in (1, 2) else
                torch.from_numpy(a).bfloat16().float().numpy()
                for i, a in enumerate(args)]
    x, dt, A, B, C = _t(args)
    y, h = _emulate(x, dt, A, B, C, L, group, split)
    ry, rh = ss.ssd_scan_plain(x, dt, A, B, C, chunk=16)
    _close(y.numpy(), ry.numpy(), TOL)
    _close(h.numpy(), rh.numpy(), TOL)
    jy, jh = ref_ssd(*_j(args), chunk=16, interpret=True)
    _close(y.numpy(), jy, TOL)
    _close(h.numpy(), jh, TOL)


def test_wrapper_rejects_bad_inputs():
    x, dt, A, B, C = _t(_inputs(12, 1, 32, 2, 8, 16))
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A, B, C, chunk=24)             # 32 % 24
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt[:, :16], A, B, C, chunk=16)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A[:1], B, C, chunk=16)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A, B, C[..., :8], chunk=16)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A, B, C, chunk=16, depth=0)
