"""The port's train step as one CUDA graph (`runtime.steps.jit_train_step`)
on the CPU, where the same step runs eagerly, against the functional step
and against the JAX reference.

`apply_updates_` and `ef_compress_` (the in-place AdamW and compression
the graph step writes into the state) equal `apply_updates` and
`ef_compress` bitwise over three steps. `jit_train_step` equals
`make_train_step` bitwise over three steps for seven reduced f32 archs
and layouts, at accum 1 and 4, with compression on and off; it matches
the reference's mesh-less `jit_train_step` on the same bridged parameters
and batches (every state leaf and the loss within the sentinel's f32
bound, 2e-3, at lr 1e-3); the port's `train(..., compress_grads=True)`
matches the reference's `train` from the same parameters. The graph
step's function, called twice on one state as `StepGraph` calls it
(eagerly, then under capture), keeps the state's keys and tensors; a
compressed run resumes exactly from its checkpoint; `donate=False` leaves
the caller's state; a dropped step frees its graph without the collector.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.runtime import steps as ref_steps
from repro.runtime import train_loop as ref_train_loop
from repro_torch.configs import get_config
from repro_torch.configs.shapes import token_split
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy
from repro_torch.models.registry import Model
from repro_torch.optim import adamw, compression
from repro_torch.optim.compression import init_error_state
from repro_torch.runtime.steps import jit_train_step, make_train_step
from repro_torch.runtime.train_loop import train

TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = {
    "yi-6b": ("yi-6b", {}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
    "mamba2-130m": ("mamba2-130m", {}),
    "mamba2-130m-split": ("mamba2-130m", {"ssm_split_proj": True}),
    "hymba-1.5b": ("hymba-1.5b", {}),
    "whisper-medium": ("whisper-medium", {}),
    "paligemma-3b": ("paligemma-3b", {}),
}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _cfg(case, ref=False):
    arch, over = ARCHS[case]
    return (ref_get_config if ref else get_config)(arch).reduced().replace(
        **F32, **over)


def _batches(cfg, n, b=4, s=16, seed=5):
    """`n` numpy batches of `cfg`'s family (frames for an enc-dec arch,
    patches for a VLM, as `configs.shapes.token_split` cuts `s`)."""
    rng = np.random.RandomState(seed)
    front, text = token_split(cfg, s)
    out = []
    for _ in range(n):
        batch = {k: rng.randint(0, cfg.vocab, (b, text)).astype(np.int32)
                 for k in ("tokens", "targets")}
        if cfg.enc_dec:
            batch["frames"] = rng.randn(b, front, cfg.d_model).astype(
                np.float32)
        if cfg.vlm:
            batch["patches"] = rng.randn(b, front, cfg.d_model).astype(
                np.float32)
        out.append(batch)
    return out


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"b": {"w": _t(rng.randn(3, 5) * scale).float(),
                  "a": _t(rng.randn(7) * scale).float()},
            "a": _t(rng.randn(2, 2, 3) * scale).float()}


def _state(seed=0, compress=False, case="granite-moe-1b-a400m"):
    cfg = _cfg(case)
    gen = torch.Generator()
    gen.manual_seed(seed)
    state = adamw.init_state(build_model(cfg).init(gen, "cpu"))
    if compress:
        state["grad_error"] = init_error_state(state["params"])
    return cfg, state


def _equal_trees(a, b):
    pa, pb = list(tree.paths(a)), list(tree.paths(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), "/".join(path)


def _close_ref(ours, ref, msg):
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    ours = list(tree.paths(ours))
    assert len(ours) == len(ref_leaves)
    for (path, a), b in zip(ours, ref_leaves):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=f"{msg} {'/'.join(path)}")


# ------------------------------------------------- in-place AdamW, EF


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_apply_updates_in_place_equals_functional_bitwise(clip):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                            grad_clip=clip)
    state = {"step": torch.tensor(4, dtype=torch.int32),
             "params": _tree(0), "mu": _tree(2, 0.1),
             "nu": tree.map_tree(torch.abs, _tree(3, 0.1))}
    ref = tree.map_tree(torch.clone, state)
    objects = [id(x) for x in tree.leaves(state)]
    for i in range(3):
        grads = _tree(10 + i, scale=3.0)
        ref, want = adamw.apply_updates(ref, grads, cfg)
        got = adamw.apply_updates_(state, grads, cfg)
        assert sorted(got) == ["grad_norm", "lr"]
        _equal_trees(got, want)
        _equal_trees(state, ref)
    assert [id(x) for x in tree.leaves(state)] == objects
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32


def test_ef_compress_in_place_equals_functional_bitwise():
    err = init_error_state(_tree(0))
    ref_err = tree.map_tree(torch.clone, err)
    objects = [id(x) for x in tree.leaves(err)]
    for i in range(3):
        grads = _tree(10 + i, scale=0.3)
        want, ref_err = compression.ef_compress(grads, ref_err)
        got = compression.ef_compress_(grads, err)
        _equal_trees(got, want)
        _equal_trees(err, ref_err)
        assert any(bool(e.abs().max() > 0) for e in tree.leaves(err))
    assert [id(x) for x in tree.leaves(err)] == objects


# ------------------------------------------ graph step == eager step


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("case", list(ARCHS))
def test_graph_step_equals_eager_step_bitwise(case, accum, compress):
    """Three steps through `jit_train_step` (the state updated in place)
    and through `make_train_step` (a new state each step) from the same
    state and batches: the same metrics and state, bitwise."""
    cfg, state = _state(1, compress, case)
    eager_state = tree.map_tree(torch.clone, state)
    model, opt = build_model(cfg), adamw.AdamWConfig(**OPT)
    step = jit_train_step(model, opt, accum=accum, compress=compress)
    eager = make_train_step(model, opt, accum=accum, compress=compress)
    for batch in _batches(cfg, 3):
        batch = {k: _t(v) for k, v in batch.items()}
        out, got = step(state, batch)
        eager_state, want = eager(eager_state, batch)
        assert out is state
        assert sorted(got) == ["grad_norm", "loss", "lr"]
        _equal_trees(got, want)
    _equal_trees(state, eager_state)
    assert int(state["step"]) == 3


def test_graph_step_keeps_the_state_objects():
    """`StepGraph` calls the step's function twice on one state (eagerly,
    then under capture): both calls leave the state dict's keys and
    tensor objects, `grad_error` included, as they were."""
    cfg, state = _state(2, compress=True)
    step = jit_train_step(build_model(cfg), adamw.AdamWConfig(**OPT),
                          compress=True)
    batch = {k: _t(v) for k, v in _batches(cfg, 1)[0].items()}
    step(state, batch)                       # fixes the batch's key order
    keys = list(state)
    leaves = [(id(x), x.data_ptr()) for x in tree.leaves(state)]
    values = [batch[k] for k in sorted(batch)]
    for _ in range(2):
        metrics = step.graph.fn(state, *values)
        assert sorted(metrics) == ["grad_norm", "loss", "lr"]
        assert list(state) == keys
        assert [(id(x), x.data_ptr()) for x in tree.leaves(state)] == leaves
    assert int(state["step"]) == 3
    assert any(bool(e.abs().max() > 0)
               for e in tree.leaves(state["grad_error"]))


def test_graph_step_without_donation_leaves_the_state():
    """`donate=False`: chained steps leave the caller's state as it was and
    equal donated steps on a copy bitwise; calling with the caller's
    state again starts from it."""
    cfg, state = _state(3)
    kept = tree.map_tree(torch.clone, state)
    donated = tree.map_tree(torch.clone, state)
    model, opt = build_model(cfg), adamw.AdamWConfig(**OPT)
    step = jit_train_step(model, opt, donate=False)
    twin = jit_train_step(model, opt)
    batches = [{k: _t(v) for k, v in b.items()} for b in _batches(cfg, 3)]
    out = state
    for batch in batches:
        out, m = step(out, batch)
        donated, dm = twin(donated, batch)
        _equal_trees(m, dm)
    assert out is not state and int(out["step"]) == 3
    _equal_trees(state, kept)
    _equal_trees(out, donated)
    again, _ = step(state, batches[0])
    assert again is out and int(again["step"]) == 1


def test_graph_step_refuses_other_batch_keys():
    cfg, state = _state(4)
    step = jit_train_step(build_model(cfg), adamw.AdamWConfig(**OPT))
    batch = {k: _t(v) for k, v in _batches(cfg, 1)[0].items()}
    step(state, batch)
    with pytest.raises(ValueError, match="batch keys"):
        step(state, {"tokens": batch["tokens"]})


def test_dropped_step_frees_its_graph_without_the_collector():
    """Nothing of a `jit_train_step` holds a reference cycle: once the step
    is dropped, its `StepGraph` (and on the card the graph's memory pool)
    goes with it, the collector off."""
    cfg, state = _state(5)
    step = jit_train_step(build_model(cfg), adamw.AdamWConfig(**OPT))
    step(state, {k: _t(v) for k, v in _batches(cfg, 1)[0].items()})
    ref = weakref.ref(step.graph)
    gc.disable()
    try:
        del step
        assert ref() is None
    finally:
        gc.enable()


# ------------------------------------------------------ the reference


@pytest.mark.parametrize("case", ["yi-6b", "granite-moe-1b-a400m",
                                  "mamba2-130m", "hymba-1.5b"])
def test_graph_step_matches_reference_jit_train_step(case):
    """Three steps of the reference's mesh-less `jit_train_step` and of the
    port's, from the same bridged parameters and batches at lr 1e-3: the
    loss of each step and every leaf of params, mu and nu within 2e-3."""
    ref_cfg, cfg = _cfg(case, ref=True), _cfg(case)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    ref_step = ref_steps.jit_train_step(ref_model,
                                        ref_adamw.AdamWConfig(**OPT))
    step = jit_train_step(build_model(cfg), adamw.AdamWConfig(**OPT))
    ref_state = ref_adamw.init_state(ref_params)
    state = adamw.init_state(params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu"))
    for i, batch in enumerate(_batches(cfg, 3)):
        ref_state, rm = ref_step(ref_state, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
    assert int(state["step"]) == int(ref_state["step"]) == 3
    for k in ("params", "mu", "nu"):
        _close_ref(state[k], ref_state[k], k)


def test_compressed_train_matches_reference_train(monkeypatch):
    """`train(..., compress_grads=True)` of the port and of the reference
    (whose `jit_train_step` takes no compression), reduced f32 granite-moe
    from the same parameters (the port's `Model.init` returns the
    reference's, bridged) and the same Markov batches: every step's loss
    within 2e-3."""
    ref_cfg, cfg = _cfg("granite-moe-1b-a400m", ref=True), \
        _cfg("granite-moe-1b-a400m")
    ref_model = ref_build_model(ref_cfg)
    np_params = jax.tree.map(np.asarray,
                             ref_model.init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(Model, "init", lambda self, gen, device:
                        params_from_numpy(np_params, self.cfg, device))
    data = dict(vocab=cfg.vocab, seq_len=16, global_batch=4)
    kw = dict(steps=4, log_every=1, compress_grads=True)
    want = ref_train_loop.train(ref_model, data_cfg=RefDataConfig(**data),
                                opt=ref_adamw.AdamWConfig(**OPT), **kw)
    got = train(build_model(cfg), data_cfg=DataConfig(**data),
                opt=adamw.AdamWConfig(**OPT), device="cpu", **kw)
    assert sorted(got.losses) == sorted(want.losses) == [0, 1, 2, 3]
    np.testing.assert_allclose([got.losses[i] for i in range(4)],
                               [want.losses[i] for i in range(4)],
                               rtol=TOL, atol=TOL)


# ------------------------------------------------------ the train loop


def test_compressed_train_resumes_exactly_from_a_checkpoint(tmp_path):
    """A compressed run of three steps, checkpointed, then resumed to six
    ends bitwise where the uninterrupted run of six ends: the losses
    after the resume and the final checkpoint (the error state in it)."""
    cfg = _cfg("yi-6b")
    kw = dict(steps=6, data_cfg=DataConfig(vocab=cfg.vocab, seq_len=16,
                                           global_batch=4),
              opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6),
              compress_grads=True, log_every=1, seed=4, device="cpu")
    whole = train(build_model(cfg), ckpt_dir=tmp_path / "a", ckpt_every=100,
                  **kw)
    train(build_model(cfg), ckpt_dir=tmp_path / "b", **{**kw, "steps": 3})
    resumed = train(build_model(cfg), ckpt_dir=tmp_path / "b", **kw)
    assert resumed.resumed_from == 3
    assert resumed.losses == {k: whole.losses[k] for k in (3, 4, 5)}
    a = np.load(tmp_path / "a" / "step_00000006" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_00000006" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    assert len(a.files) == 1 + 4 * len(tree.leaves(
        build_model(cfg).param_specs()))     # step, params, mu, nu, error
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
