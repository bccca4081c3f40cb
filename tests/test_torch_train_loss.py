"""The port's training loss and its gradients against the JAX reference,
and K2 (`moe_gmm`) differentiated through K2 itself.

For reduced f32 yi-6b, granite-moe-1b-a400m and mamba2-130m (joint and
split projections), the reference's seeded parameters are bridged with
`params_from_numpy`, and the port's `loss_fn` (total, CE and MoE aux) and
every gradient leaf are held to ``jax.value_and_grad(repro...loss_fn)`` on
the same numpy batch (B 2, S 32) at the sentinel's f32 bound, 2e-3 (rtol
and atol). Each arch's reference gradient is computed once per module.
(The hybrid, enc-dec and VLM families: `test_torch_train_families.py`.)

`moe_gmm`'s `autograd.Function` is held to the einsum's autograd at 1e-4
for a shared token block (a leading 1, and a caller's stride-0 view) and
per-expert tokens, and its backward is shown to run `gmm` twice. A kernel
with no backward refuses an operand that requires grad on the CUDA route
(`ring.guarded`), and the CPU route keeps autograd.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import token_split as ref_token_split
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.configs.shapes import token_split
from repro_torch.core import tree
from repro_torch.kernels import ring
from repro_torch.kernels.moe_gmm import moe_gmm as mg
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.stream_copy import stream_copy as sc
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy
from repro_torch.runtime.steps import value_and_grad

TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
CASES = {
    "yi-6b": ("yi-6b", {}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
    "mamba2-130m": ("mamba2-130m", {}),
    "mamba2-130m-split": ("mamba2-130m", {"ssm_split_proj": True}),
}


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _batch(cfg, seed, b=2, s=32):
    rng = np.random.RandomState(seed)
    front, text = token_split(cfg, s)
    out = {"tokens": rng.randint(0, cfg.vocab, (b, text)).astype(np.int32),
           "targets": rng.randint(0, cfg.vocab, (b, text)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.randn(b, front, cfg.d_model).astype(np.float32)
    if cfg.vlm:
        out["patches"] = rng.randn(b, front, cfg.d_model).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _run(case):
    """Both packages' loss, metrics and gradients for one reduced arch."""
    arch, over = CASES[case]
    ref_cfg = ref_get_config(arch).reduced().replace(**F32, **over)
    cfg = get_config(arch).reduced().replace(**F32, **over)
    assert token_split(cfg, 32) == ref_token_split(ref_cfg, 32)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, 1)
    (ref_total, ref_m), ref_g = jax.value_and_grad(ref_model.loss,
                                                   has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    model = build_model(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, m = model.loss(params, tb)
    _, grads = value_and_grad(model, params, tb)
    ref = {"total": float(ref_total), "loss": float(ref_m["loss"]),
           "aux": float(ref_m["aux"]),
           "grads": [np.asarray(g) for g in jax.tree.leaves(ref_g)],
           "paths": [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(ref_g)[0]]}
    ours = {"total": float(total), "loss": float(m["loss"]),
            "aux": float(m["aux"]), "grads": list(tree.paths(grads))}
    return cfg, ref, ours


@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(case):
    cfg, ref, ours = _run(case)
    for k in ("total", "loss", "aux"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=TOL, atol=TOL)
    assert (ours["aux"] > 0) == cfg.moe          # only MoE adds an aux term
    np.testing.assert_allclose(
        ours["total"], ours["loss"] + cfg.router_aux_coef * ours["aux"],
        rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_every_gradient_leaf_matches_reference(case):
    _, ref, ours = _run(case)
    assert len(ours["grads"]) == len(ref["grads"])
    for (path, g), want, ref_path in zip(ours["grads"], ref["grads"],
                                         ref["paths"]):
        # the same leaf in the same (sorted, depth-first) order
        assert ref_path == "".join(f"['{k}']" for k in path)
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg="/".join(path))
        assert torch.isfinite(g).all()


# ------------------------------------------------------- K2's backward


def _gmm_grads(tokens, weights, seed, *, through_kernel):
    rng = np.random.RandomState(seed)
    t = tokens.clone().requires_grad_(True)
    w = weights.clone().requires_grad_(True)
    e = w.shape[0]
    xs = t
    if through_kernel:
        out = gmm_ops.moe_gmm(xs, w)
    else:
        out = torch.einsum("ecd,edf->ecf", xs.expand(e, -1, -1), w)
    r = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    (out * r).sum().backward()
    return out.detach(), t.grad, w.grad


@pytest.mark.parametrize("lead", ["shared", "per_expert"])
@pytest.mark.parametrize("e,c,dm,f", [(4, 16, 64, 32), (3, 5, 17, 130),
                                      (1, 9, 8, 8)])
def test_moe_gmm_backward_matches_einsum_autograd(lead, e, c, dm, f):
    rng = np.random.RandomState(e * 100 + c)
    lead_e = 1 if lead == "shared" else e
    tokens = torch.from_numpy(rng.randn(lead_e, c, dm).astype(np.float32))
    weights = torch.from_numpy(rng.randn(e, dm, f).astype(np.float32))
    got = _gmm_grads(tokens, weights, 7, through_kernel=True)
    want = _gmm_grads(tokens, weights, 7, through_kernel=False)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_moe_gmm_backward_through_a_callers_stride0_view():
    """A caller's own stride-0 expansion of one token block: d tokens comes
    back per expert and the expansion's backward sums it."""
    rng = np.random.RandomState(3)
    block = torch.from_numpy(rng.randn(1, 12, 24).astype(np.float32))
    weights = torch.from_numpy(rng.randn(5, 24, 16).astype(np.float32))
    grads = []
    for via in ("kernel", "einsum"):
        t = block.clone().requires_grad_(True)
        w = weights.clone().requires_grad_(True)
        xs = t.expand(5, -1, -1)
        assert xs.stride(0) == 0
        out = (gmm_ops.moe_gmm(xs, w) if via == "kernel"
               else torch.einsum("ecd,edf->ecf", xs, w))
        (out ** 2).sum().backward()
        grads.append((t.grad, w.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_moe_gmm_backward_runs_gmm_on_both_products(monkeypatch):
    calls = []
    real = gmm_ops.gmm

    def counting(tokens, weights, **kw):
        calls.append((tuple(tokens.shape), tokens.stride(0),
                      tuple(weights.shape), weights.is_contiguous()))
        return real(tokens, weights, **kw)

    monkeypatch.setattr(gmm_ops, "gmm", counting)
    t = torch.randn(1, 6, 8, requires_grad=True)
    w = torch.randn(3, 8, 4, requires_grad=True)
    gmm_ops.moe_gmm(t, w).sum().backward()
    # forward; d tokens = d out @ w^T (contiguous [E, f, dm]); d weights =
    # t^T @ d out, the shared block transposed once at expert stride 0
    assert calls == [((3, 6, 8), 0, (3, 8, 4), True),
                     ((3, 6, 4), 24, (3, 4, 8), True),
                     ((3, 8, 6), 0, (3, 6, 4), True)]
    assert t.grad.shape == (1, 6, 8) and w.grad.shape == (3, 8, 4)


def test_moe_gmm_without_grad_builds_no_graph():
    t, w = torch.randn(1, 4, 8), torch.randn(2, 8, 4)
    out = gmm_ops.moe_gmm(t, w)
    assert out.grad_fn is None and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), mg.gmm_plain(
        t.expand(2, -1, -1), w).numpy(), rtol=0, atol=0)


# ------------------------------------------- kernels with no backward


def _triad_spec():
    return sc.triad_spec(128, 4, torch.float32)


@pytest.mark.parametrize("needs_grad", [True, False])
def test_cuda_route_refuses_an_operand_that_requires_grad(needs_grad):
    """The check sits in `ring.guarded` before any launch: here the CUDA
    route is asked for on CPU tensors, so a call that passes it would
    launch nothing but a stub."""
    b = torch.randn(8, 4, requires_grad=needs_grad)
    c = torch.randn(8, 4)
    launched = []

    def launch(depth):
        launched.append(depth)
        return b.detach() + c

    kw = dict(cuda=True, depth=1)
    if needs_grad:
        with pytest.raises(ring.NoBackwardError, match="stream_triad") as ei:
            ring.guarded(_triad_spec(), (b, c), launch, lambda b, c: b + c,
                         **kw)
        assert ei.value.kernel == "stream_triad" and not launched
        with torch.no_grad():       # under no_grad the same call launches
            ring.guarded(_triad_spec(), (b, c), launch, lambda b, c: b + c,
                         **kw)
        assert launched == [1]
    else:
        ring.guarded(_triad_spec(), (b, c), launch, lambda b, c: b + c, **kw)
        assert launched == [1]


def test_cpu_route_keeps_autograd():
    b = torch.randn(8, 4, requires_grad=True)
    c = torch.randn(8, 4)
    res = ring.guarded(_triad_spec(), (b, c), lambda d: None,
                       lambda b, c: b + 2.0 * c, cuda=False, depth=1)
    res.out.sum().backward()
    np.testing.assert_array_equal(b.grad.numpy(), np.ones((8, 4), np.float32))
