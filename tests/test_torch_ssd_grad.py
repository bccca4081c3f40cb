"""K4's backward in the PyTorch port against the JAX reference.

The reference has no backward kernel: it differentiates its jnp
`ssd_chunked` (``src/repro/models/ssm.py``). The port's plain backward
(`ssd_scan_bwd_plain`, what `ssd_scan_bwd` runs on CPU tensors and the
formula the CUDA kernel runs) is held to ``jax.vjp`` of the reference's
`ssd_chunked` and to ``torch.autograd.grad`` of the port's plain forward,
on inputs drawn from a numpy seed, in f32, at 2e-3 + 2e-3 x |value|, over
chunks of 16, 32 and 64 rows, several chunks a sequence, one head and
more than `HEAD_GROUP`, x, B and C as strided slices of one projection,
dh_final None and given, a strong decay (dt 8, A -1) and a weak one
(dt in [0.005, 0.03): what is carried across chunks counts). Under the
strong decay the reference's `ssd_chunked` has no finite vjp (its mask
comes after the exponent: 0 x inf in the backward), so that case is held
to the vjp of the reference's `ssd_sequential`, and to the autograd of
the port's.

`ops.ssd` (the `autograd.Function`) runs one `ssd_scan_bwd` call a
backward and takes h_final's gradient as None; reduced mamba2-130m (joint
and split projections) and hymba-1.5b train through it, and their loss
and every gradient leaf match ``jax.value_and_grad`` of the reference at
2e-3. The kernel itself is held to the plain backward on the card
(`test_torch_kernels_cuda.py`, `chip_smoke.py` phase 11c).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.core import autotune, tree
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan import ssd_scan as ss
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy
from repro_torch.models.ssm import ssd_sequential
from repro_torch.runtime.steps import value_and_grad

TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _problem(seed, b, s, nh, p, n, *, strided, with_dh, strong,
             weak=False):
    """numpy x, dt, A, B, C (the reference tests' draws; dt 8 and A -1 when
    `strong`; dt in [0.005, 0.03) when `weak`, so that the gradient carried
    back across chunks counts), dy and dh_final (or None); the port's x, B
    and C as slices of one joint [b, s, nh p + 2 n] projection when
    `strided`."""
    rng = np.random.RandomState(seed)
    joint = rng.randn(b, s, nh * p + 2 * n).astype(np.float32)
    x = joint[..., :nh * p].reshape(b, s, nh, p)
    B, C = joint[..., nh * p:nh * p + n], joint[..., nh * p + n:]
    dt = (rng.rand(b, s, nh) * 0.5 + 0.1).astype(np.float32)
    A = (-np.exp(rng.randn(nh) * 0.3)).astype(np.float32)
    if strong:
        dt, A = np.full_like(dt, 8.0), np.full_like(A, -1.0)
    if weak:
        dt = (dt * 0.05).astype(np.float32)
    dy = rng.randn(b, s, nh, p).astype(np.float32)
    dh = rng.randn(b, nh, p, n).astype(np.float32) if with_dh else None
    ref = [np.ascontiguousarray(a) for a in (x, dt, A, B, C)]
    if strided:
        tj = torch.from_numpy(joint)
        ours = [tj[..., :nh * p].reshape(b, s, nh, p), torch.from_numpy(dt),
                torch.from_numpy(A), tj[..., nh * p:nh * p + n],
                tj[..., nh * p + n:]]
        assert not ours[0].is_contiguous() and not ours[3].is_contiguous()
    else:
        ours = [torch.from_numpy(a) for a in ref]
    return ref, ours, dy, dh


def _reference_vjp(fn, ref, dy, dh):
    """The reference's (dx, ddt, dA, dB, dC) through ``jax.vjp``."""
    (y, h), vjp = jax.vjp(fn, *map(jnp.asarray, ref))
    return [np.asarray(g) for g in vjp(
        (jnp.asarray(dy), jnp.zeros_like(h) if dh is None
         else jnp.asarray(dh)))]


def _close(got, want, what):
    for name, a, b in zip(NAMES, got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape, (what, name)
        assert np.isfinite(a).all(), (what, name)
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {name}")


GRID = [  # chunk, chunks, nh, p, n, strided, dh_final given, decay
    (16, 4, 1, 8, 16, False, False, "normal"),
    (16, 3, 13, 8, 8, True, True, "normal"),  # 13 heads: past HEAD_GROUP
    (32, 3, 2, 8, 16, False, True, "normal"),
    (32, 2, 12, 16, 8, True, False, "normal"),
    (64, 2, 3, 16, 32, True, True, "normal"),
    (64, 1, 2, 8, 16, False, True, "normal"),
    (16, 2, 2, 4, 8, False, True, "strong"),  # dt 8, A -1
    (32, 3, 13, 8, 16, True, False, "strong"),
    (64, 2, 2, 8, 16, True, True, "strong"),
    (16, 4, 3, 8, 16, True, True, "weak"),    # dt in [0.005, 0.03)
    (64, 3, 13, 8, 8, False, True, "weak"),
]


@pytest.mark.parametrize("chunk,chunks,nh,p,n,strided,with_dh,decay", GRID)
def test_plain_backward_matches_reference(chunk, chunks, nh, p, n, strided,
                                          with_dh, decay):
    s = chunk * chunks
    strong = decay == "strong"
    ref, ours, dy, dh = _problem(chunk + 7 * nh + n, 2, s, nh, p, n,
                                 strided=strided, with_dh=with_dh,
                                 strong=strong, weak=decay == "weak")
    got = ss.ssd_scan_bwd_plain(*ours, torch.from_numpy(dy),
                                None if dh is None else torch.from_numpy(dh),
                                chunk=chunk)
    assert [t.dtype for t in got] == [torch.float32] * 5
    # the reference: its chunked SSD, or (its vjp not finite under the
    # strong decay) its sequential recurrence
    fn = ref_ssm.ssd_sequential if strong else \
        functools.partial(ref_ssm.ssd_chunked, chunk=chunk)
    _close(got, _reference_vjp(fn, ref, dy, dh), "reference vjp")
    # the port's plain forward through torch's autograd (under the strong
    # decay its sequential recurrence: the chunked forward's autograd sums
    # the gradient of cs through terms that cancel, and loses dA by ~0.3%
    # in f32, which the plain backward's form avoids)
    leaves = [t.clone().requires_grad_(True) for t in ours]
    y, h = ssd_sequential(*leaves) if strong else \
        ss.ssd_scan_plain(*leaves, chunk=chunk)
    outs, grads_in = [y], [torch.from_numpy(dy)]
    if dh is not None:
        outs.append(h)
        grads_in.append(torch.from_numpy(dh))
    _close(got, torch.autograd.grad(outs, leaves, grads_in),
           "torch autograd of the plain forward")


def test_reference_chunked_vjp_is_not_finite_under_strong_decay():
    """Why the strong-decay cases take `ssd_sequential`'s vjp: the
    reference's `ssd_chunked` masks after the exponent, so its backward
    meets 0 x inf above the diagonal, while the port's plain backward
    (masked before the exponent) stays finite."""
    ref, ours, dy, dh = _problem(3, 1, 32, 2, 4, 8, strided=False,
                                 with_dh=True, strong=True)
    want = _reference_vjp(functools.partial(ref_ssm.ssd_chunked, chunk=16),
                          ref, dy, dh)
    assert not all(np.isfinite(g).all() for g in want)
    got = ss.ssd_scan_bwd_plain(*ours, torch.from_numpy(dy),
                                torch.from_numpy(dh), chunk=16)
    assert all(torch.isfinite(g).all() for g in got)


def test_wrapper_on_cpu_runs_the_plain_backward():
    """`ssd_scan_bwd` on CPU tensors: the plain version, no launch, the
    depth solved and recorded (the heads a block of the kernel walks)."""
    ref, ours, dy, dh = _problem(4, 2, 64, 3, 8, 16, strided=True,
                                 with_dh=True, strong=False)
    dy, dh = torch.from_numpy(dy), torch.from_numpy(dh)
    got = ss.ssd_scan_bwd(*ours, dy, dh, chunk=16)
    want = ss.ssd_scan_bwd_plain(*ours, dy, dh, chunk=16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert launch_counts()["ssd_scan_bwd"] == 0
    assert 1 <= autotune.last_choice("ssd_scan_bwd") <= 3
    with pytest.raises(ValueError):        # dy of another shape
        ss.ssd_scan_bwd(*ours, dy[:, :32], chunk=16)


def test_bwd_plan_and_shared_memory():
    """The kernel's plan: 64-row chunks in both types, the head group
    solved from the grid (the fewest waves of blocks, one an SM, times the
    heads a block walks; the largest on a tie) or given, the depth read as
    the heads' tiles a block keeps in flight (clamped to the group and to
    shared memory), four launches; mamba2's widths fit one slot in bf16
    and in f32, hymba's several, p = n = 128 none."""
    from repro_torch.core.guard import KernelResourceError

    run = ss.bwd_plan(8, 512, 24, 64, 128, 2, 5)
    assert (run.chunk, run.chunks, run.group, run.groups, run.depth,
            run.launches) == (64, 8, 12, 2, 1, 4)
    assert run.workspace_bytes == 4 * (2 * 8 * 8 * 24 * (64 * 128 + 1)
                                       + 2 * 2 * 8 * 512 * 128)
    hymba = ss.bwd_plan(8, 500, 50, 64, 16, 2, 100)
    assert (hymba.chunks, hymba.group, hymba.groups) == (8, 25, 2)
    assert 2 < hymba.depth <= hymba.group
    assert ss.bwd_plan(8, 512, 24, 64, 128, 2, 1, group=24).groups == 1
    assert ss.bwd_plan(2, 256, 12, 64, 16, 4, 3, group=5).depth == 3
    assert ss.bwd_group(8, 8, 24, sms=132) == 12      # 128 blocks, one wave
    assert ss.bwd_group(2, 4, 12, sms=132) == 1
    assert ss.bwd_smem_bytes(64, 128, 2) <= ring.SMEM_LIMIT < \
        ss.bwd_smem_bytes(64, 128, 2, 2)              # mamba2-130m, bf16
    assert ss.bwd_smem_bytes(64, 128, 4) <= ring.SMEM_LIMIT < \
        ss.bwd_smem_bytes(64, 128, 4, 2)
    assert ss.bwd_smem_bytes(64, 16, 2, 2) <= ring.SMEM_LIMIT // 2  # hymba
    for itemsize in (2, 4):
        assert ss.bwd_smem_bytes(128, 128, itemsize) > ring.SMEM_LIMIT
        with pytest.raises(KernelResourceError):
            ss.bwd_plan(1, 64, 1, 128, 128, itemsize, 1)
    with pytest.raises(ValueError):
        ss.bwd_plan(8, 512, 24, 64, 128, 2, 0)


def test_bwd_layout_follows_the_kernel_source():
    """`_bwd_layout` mirrors the .cu's `Layout`, which the wrapper's shared
    memory clamp reads: 64-row chunks, bf16 rows 8 values longer and f32
    rows 4, the vectors, the fixed parts and slots of both launches."""
    from pathlib import Path

    src = Path(ss.BWD_SOURCE).read_text()
    for text in (f"constexpr int kL = {ss.BWD_CHUNK};",
                 f"constexpr int kMaxState = {ss.MAX_STATE};",
                 f"constexpr int kMaxHead = {ss.MAX_HEAD};",
                 "const int pad = f32 ? 4 : 8, esz = f32 ? 4 : 2;",
                 "constexpr int kVecRows = 6;",
                 "constexpr int kVecFloats = (kVecRows + 24 + 1) * kL;",
                 "return 2 * bc + 2 * (kL * xs * 4) + 2 * kL * 4; }",
                 "size_t slot_a() const { return 2 * x + dtw; }",
                 "size_t fixed_c() const { return 2 * bc + sc + vec; }",
                 "size_t slot_c() const { return 2 * x + 2 * st + dtw; }",
                 '#include "../../csrc/coro_ring.cuh"',
                 '#include "../../csrc/ssd_common.cuh"'):
        assert text in src, text
    # bf16, mamba2's widths: B and C [64][136], x w and dy exp(cs) [64][72]
    # in two parts, w and exp(cs); x and dy [64][72]; the scores [64][72]
    # in two parts, 31 vectors of 64; H and G [64][136] in two parts each
    assert ss._bwd_layout(64, 128, 2) == dict(
        fixed_a=2 * 64 * 136 * 2 + 2 * 64 * 72 * 4 + 2 * 64 * 4,
        slot_a=2 * 64 * 72 * 2 + 64 * 4,
        fixed_c=2 * 64 * 136 * 2 + 64 * 72 * 4 + 31 * 64 * 4,
        slot_c=2 * 64 * 72 * 2 + 2 * 64 * 136 * 4 + 64 * 4)
    # f32, hymba's: rows 4 longer, p and n padded to 16
    assert ss._bwd_layout(64, 16, 4)["slot_c"] == \
        2 * 64 * 68 * 4 + 2 * 64 * 20 * 4 + 64 * 4


def test_ssd_op_backward_is_one_bwd_call(monkeypatch):
    """`ops.ssd` under grad: the forward, then one `ssd_scan_bwd` call in
    the backward; h_final's gradient arrives as None (training uses only
    y), and the gradients equal the plain version's autograd."""
    calls = []
    real = ops.ssd_scan_bwd

    def counting(*args, **kw):
        calls.append(args[6])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "ssd_scan_bwd", counting)
    ref, ours, dy, _ = _problem(5, 2, 64, 13, 8, 16, strided=True,
                                with_dh=False, strong=False)
    grads = []
    for via in ("op", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in ours]
        fwd = ops.ssd if via == "op" else ss.ssd_scan_plain
        y, _ = fwd(*leaves, chunk=16)
        (y * torch.from_numpy(dy)).sum().backward()
        grads.append([t.grad for t in leaves])
    assert calls == [None]
    _close(grads[0], grads[1], "ops.ssd against autograd")
    # without grad the op builds no graph
    y, h = ops.ssd(*ours, chunk=16)
    assert y.grad_fn is None and not h.requires_grad


# --------------------------------------------- reduced models through K4


CASES = {
    "mamba2-130m": ("mamba2-130m", {}),
    "mamba2-130m-split": ("mamba2-130m", {"ssm_split_proj": True}),
    "hymba-1.5b": ("hymba-1.5b", {}),
}


@functools.lru_cache(maxsize=None)
def _train_run(case):
    """Both packages' loss and gradients for one reduced arch (B 2, S 32:
    two chunks of 16), and the backward calls the port's step made."""
    arch, over = CASES[case]
    ref_cfg = ref_get_config(arch).reduced().replace(**F32, **over)
    cfg = get_config(arch).reduced().replace(**F32, **over)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    batch = {k: rng.randint(0, cfg.vocab, (2, 32)).astype(np.int32)
             for k in ("tokens", "targets")}
    (ref_total, _), ref_g = jax.value_and_grad(ref_model.loss, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    calls = []
    real = ops.ssd_scan_bwd

    def counting(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    ops.ssd_scan_bwd = counting
    try:
        total, grads = value_and_grad(build_model(cfg), params,
                                      {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    finally:
        ops.ssd_scan_bwd = real
    return (cfg, float(ref_total), [np.asarray(g) for g in
                                    jax.tree.leaves(ref_g)],
            float(total), list(tree.paths(grads)), calls)


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_model_trains_through_the_backward(case):
    cfg, ref_total, ref_grads, total, grads, calls = _train_run(case)
    # one backward call a layer, on the whole sequence (s 32, chunk 16)
    assert len(calls) == cfg.n_layers
    assert all(c[1] == 32 and c[1] % cfg.ssm_chunk == 0 for c in calls)
    np.testing.assert_allclose(total, ref_total, rtol=TOL, atol=TOL)
    assert len(grads) == len(ref_grads)
    for (path, g), want in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg="/".join(path))
        assert torch.isfinite(g).all()
