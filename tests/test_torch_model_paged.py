"""The port's paged model forward against the JAX reference.

Parameters are made by the reference's `model.init` and bridged through
numpy (`params_from_numpy`); pools and inputs are made with numpy from a
seed. Decode-step and prefill-chunk logits (and the KV rows they write)
must agree within the reference's f32 parity bound, 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy

TOL = 2e-3
ARCHS = ["yi-6b", "granite-3-2b"]      # untied and tied embeddings


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _cfgs(arch):
    f32 = dict(dtype="float32", param_dtype="float32")
    return (ref_get_config(arch).reduced().replace(**f32),
            get_config(arch).reduced().replace(**f32))


def _bridge(arch, seed=0):
    ref_cfg, cfg = _cfgs(arch)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_model, ref_params, build_model(cfg), \
        params_from_numpy(tree, cfg, "cpu"), cfg


def _pools(rng, cfg, nb, blk):
    shape = (cfg.n_layers, nb, blk, cfg.kv_heads, cfg.resolved_head_dim)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_keeps_names_and_shapes(arch):
    ref_model, ref_params, model, params, cfg = _bridge(arch)
    flat_ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(ref_params)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from flat(v, p)
            else:
                yield p, v

    ours = dict(flat(params))
    assert set(ours) == set(flat_ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), flat_ref[k])
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert model.n_params() == ref_model.n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_reference(arch):
    """Ragged lengths within one round plus a zero-length padding row on
    the garbage page: logits and the written KV rows agree."""
    ref_model, ref_params, model, params, cfg = _bridge(arch)
    rng = np.random.RandomState(1)
    blk, nb = 4, 24
    kp, vp = _pools(rng, cfg, nb, blk)
    lengths = np.array([5, 17, 0, 30], np.int32)
    tables = np.zeros((4, 8), np.int32)
    ids = rng.permutation(np.arange(1, nb))
    tables[0, :2] = ids[0:2]
    tables[1, :5] = ids[2:7]
    tables[3, :8] = ids[7:15]
    tokens = rng.randint(0, cfg.vocab, (4, 1)).astype(np.int32)

    ref_logits, ref_kp, ref_vp = ref_model.decode_step_paged(
        ref_params, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), {"tokens": jnp.asarray(tokens)})
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, out_kp, out_vp = model.decode_step_paged(
        params, tkp, tvp, torch.from_numpy(tables), torch.from_numpy(lengths),
        {"tokens": torch.from_numpy(tokens)})
    assert out_kp is tkp and out_vp is tvp          # written in place
    assert logits.shape == ref_logits.shape and logits.dtype == torch.float32
    real = [0, 1, 3]
    np.testing.assert_allclose(logits.numpy()[real],
                               np.asarray(ref_logits)[real], rtol=TOL, atol=TOL)
    assert np.isfinite(logits.numpy()).all()
    live = sorted(set(tables[real].ravel()) - {0})  # every page but garbage
    np.testing.assert_allclose(tkp.numpy()[:, live], np.asarray(ref_kp)[:, live],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tvp.numpy()[:, live], np.asarray(ref_vp)[:, live],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_paged_matches_reference(arch):
    """A chunk that starts mid-block after a shared prefix: the prefix pages
    are read, the chunk's rows written (padding to the garbage page), and
    the last real token's logits agree."""
    ref_model, ref_params, model, params, cfg = _bridge(arch)
    rng = np.random.RandomState(2)
    blk, nb = 4, 16
    kp, vp = _pools(rng, cfg, nb, blk)
    start, n_valid, padded = 6, 5, 8                # positions 6..10, pad to 8
    table = np.zeros((1, 5), np.int32)
    table[0, :3] = [9, 3, 12]                       # prefix pages 9, 3; then 12
    chunk = np.zeros((1, padded), np.int32)
    chunk[0, :n_valid] = rng.randint(0, cfg.vocab, n_valid)

    ref_logits, ref_kp, ref_vp = ref_model.prefill_chunk_paged(
        ref_params, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(start, jnp.int32), {"tokens": jnp.asarray(chunk)},
        jnp.asarray(n_valid, jnp.int32))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    logits, _, _ = model.prefill_chunk_paged(
        params, tkp, tvp, torch.from_numpy(table), start,
        {"tokens": torch.from_numpy(chunk)}, n_valid)
    assert logits.shape == (1, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=TOL, atol=TOL)
    for pool, ref in ((tkp, ref_kp), (tvp, ref_vp)):
        np.testing.assert_allclose(pool.numpy()[:, [9, 3, 12]],
                                   np.asarray(ref)[:, [9, 3, 12]],
                                   rtol=TOL, atol=TOL)
        untouched = [b for b in range(1, nb) if b not in (9, 3, 12)]
        np.testing.assert_array_equal(pool.numpy()[:, untouched],
                                      kp[:, untouched] if pool is tkp
                                      else vp[:, untouched])


def test_params_from_numpy_rejects_mismatched_trees():
    ref_model, ref_params, model, params, cfg = _bridge("yi-6b")
    tree = jax.tree.map(np.asarray, ref_params)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError):
        params_from_numpy(tree, cfg, "cpu")
    tree = jax.tree.map(np.asarray, ref_params)
    tree["extra"] = np.zeros(3)
    with pytest.raises(ValueError):
        params_from_numpy(tree, cfg, "cpu")


def test_initialize_is_seeded_and_declared():
    """`initialize` draws the declared shapes/dtypes from its generator:
    one seed, one set of weights."""
    cfg = get_config("yi-6b").reduced().replace(param_dtype="bfloat16")
    model = build_model(cfg)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(7)
    g2.manual_seed(7)
    a, b = model.init(g1, "cpu"), model.init(g2, "cpu")
    assert a["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert a["layers"]["attn"]["wq"].dtype == torch.bfloat16
    torch.testing.assert_close(a["embed"], b["embed"], rtol=0, atol=0)
    assert bool((a["layers"]["mlp"]["ln"] == 1).all())
