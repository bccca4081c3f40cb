"""The port's training loss and its gradients against the JAX reference
for the hybrid, encoder-decoder and VLM families.

For reduced f32 hymba-1.5b, whisper-medium (frame embeddings into the
encoder, a quarter as many text tokens) and paligemma-3b (8 patch
embeddings as the prefix, cut before the unembedding), the reference's
seeded parameters are bridged with `params_from_numpy`, and the port's
`loss_fn` and every gradient leaf are held to
``jax.value_and_grad(repro...loss_fn)`` on the same numpy batch (B 2,
S 32) at the sentinel's f32 bound, 2e-3 (rtol and atol). Each arch's
reference gradient is computed once per module. (Dense, MoE and SSM:
`test_torch_train_loss.py`.)
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
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy
from repro_torch.runtime.steps import value_and_grad

TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
CASES = {
    "hymba-1.5b": ("hymba-1.5b", {}),
    "whisper-medium": ("whisper-medium", {}),
    "paligemma-3b": ("paligemma-3b", {}),
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
