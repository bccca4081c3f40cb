"""The port's data pipeline, checkpoints and shape specs against the JAX
reference.

Markov batches for steps 0-3 and 2 shards are bitwise the reference's,
and so is the chain (successors, probabilities, entropy); the prefetch
iterator yields the same steps in order. A checkpoint written by the
reference restores into the port's template and one written by the port
into the reference's, leaf for leaf and bitwise (the ``leaf_i`` order is
``jax.tree.flatten``'s: keys sorted, depth first); the tmp dir of a save
is never visible, `keep` prunes, and a bfloat16 leaf comes back exactly.
The shape suites, `cell_supported`, `batch_specs`,
`decode_batch_specs` and `cache_seq_len` equal the reference's for every
shipped arch.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.checkpointing import checkpoint as ref_ckpt
from repro.configs import ALL_ARCH_NAMES as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import shapes as ref_shapes
from repro.data import pipeline as ref_pipeline
from repro.optim import adamw as ref_adamw
from repro_torch.checkpointing import checkpoint
from repro_torch.configs import ALL_ARCH_NAMES, get_config
from repro_torch.configs import shapes
from repro_torch.core import tree
from repro_torch.data import pipeline
from repro_torch.optim import adamw


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_markov_batches_are_bitwise_the_references(step, shard):
    kw = dict(vocab=97, seq_len=24, global_batch=8, seed=5, branching=3,
              num_shards=2, shard=shard)
    got = pipeline.MarkovTask(pipeline.DataConfig(**kw)).batch_for_step(step)
    want = ref_pipeline.MarkovTask(
        ref_pipeline.DataConfig(**kw)).batch_for_step(step)
    assert sorted(got) == sorted(want) == ["positions", "targets", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == (4, 24)
        np.testing.assert_array_equal(got[k], want[k])


def test_markov_chain_and_entropy_match_reference():
    cfg = dict(vocab=256, seq_len=8, global_batch=2, branching=4)
    ours = pipeline.MarkovTask(pipeline.DataConfig(**cfg))
    ref = ref_pipeline.MarkovTask(ref_pipeline.DataConfig(**cfg))
    np.testing.assert_array_equal(ours.succ, ref.succ)
    np.testing.assert_array_equal(ours.probs, ref.probs)
    assert ours.entropy() == ref.entropy()


def test_prefetch_iterator_yields_the_steps_in_order():
    task = pipeline.MarkovTask(pipeline.DataConfig(vocab=31, seq_len=6,
                                                   global_batch=2))
    it = pipeline.PrefetchIterator(task, start_step=3)
    try:
        for want in (3, 4, 5):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          task.batch_for_step(want)["tokens"])
    finally:
        it.close()


# -------------------------------------------------------------- checkpoints


def _state_np(seed):
    rng = np.random.RandomState(seed)
    params = {"layers": {"wq": rng.randn(2, 4, 3).astype(np.float32),
                         "ln": rng.randn(2, 4).astype(np.float32)},
              "embed": rng.randn(5, 4).astype(np.float32)}
    return {"step": np.asarray(7, np.int32), "params": params,
            "mu": jax.tree.map(lambda a: a * 0.5, params),
            "nu": jax.tree.map(np.abs, params)}


def _torch_template(state):
    return tree.map_tree(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        np.asarray(a)).dtype), state)


def test_reference_checkpoint_restores_into_the_ports_template(tmp_path):
    state = _state_np(0)
    ref_ckpt.save(jax.tree.map(jnp.asarray, state), tmp_path, 7)
    assert checkpoint.latest_step(tmp_path) == 7
    got = checkpoint.restore(tmp_path, _torch_template(state))
    for (path, a), b in zip(tree.paths(got), jax.tree.leaves(state)):
        assert isinstance(a, torch.Tensor), path
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.numpy().dtype == np.asarray(b).dtype


def test_port_checkpoint_restores_into_the_references_template(tmp_path):
    state = _state_np(1)
    ours = tree.map_tree(lambda a: torch.from_numpy(np.array(a)), state)
    checkpoint.save(ours, tmp_path, 3)
    assert ref_ckpt.latest_step(tmp_path) == 3
    template = ref_adamw.init_state(jax.tree.map(jnp.asarray,
                                                 state["params"]))
    got = ref_ckpt.restore(tmp_path, template)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b)
    meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
    assert meta["step"] == 3 and meta["n_leaves"] == len(tree.leaves(state))


def test_save_commits_atomically_and_prunes(tmp_path):
    state = tree.map_tree(lambda a: torch.from_numpy(np.array(a)),
                          _state_np(2))
    ck = checkpoint.AsyncCheckpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ck.save_async(state, step)
        ck.wait()
        names = sorted(p.name for p in tmp_path.iterdir())
        assert not [n for n in names if n.startswith(".tmp")]
    assert names == ["step_00000002", "step_00000003"]
    # a tmp dir left by a crashed save is never taken for a checkpoint
    (tmp_path / ".tmp_step_9_1").mkdir()
    assert checkpoint.latest_step(tmp_path) == 3
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(tmp_path, {"only": torch.zeros(1)})


def test_bfloat16_and_device_of_the_template_come_back(tmp_path):
    x = torch.randn(4, 6).to(torch.bfloat16)
    checkpoint.save({"w": x, "step": torch.tensor(2, dtype=torch.int32)},
                    tmp_path, 2)
    got = checkpoint.restore(tmp_path, {"w": torch.zeros(4, 6,
                                                         dtype=torch.bfloat16),
                                        "step": torch.zeros((),
                                                            dtype=torch.int32)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 2


def test_optimizer_state_round_trips_bitwise(tmp_path):
    params = tree.map_tree(lambda a: torch.from_numpy(np.array(a)),
                           _state_np(3)["params"])
    st = adamw.init_state(params)
    st["mu"] = tree.map_tree(lambda p: p * 3, params)
    checkpoint.save(st, tmp_path, 1)
    back = checkpoint.restore(tmp_path, adamw.init_state(
        tree.map_tree(torch.zeros_like, params)))
    for a, b in zip(tree.leaves(back), tree.leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------------- shapes


def test_shape_suites_match_reference():
    assert shapes.ALL_SHAPE_NAMES == ref_shapes.ALL_SHAPE_NAMES
    for name, s in shapes.SHAPES.items():
        r = ref_shapes.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            r.name, r.seq_len, r.global_batch, r.kind)


@pytest.mark.parametrize("arch", ALL_ARCH_NAMES)
def test_input_specs_match_reference(arch):
    assert set(ALL_ARCH_NAMES) == set(REF_ARCHS)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name, suite in shapes.SHAPES.items():
        ref_suite = ref_shapes.SHAPES[name]
        assert shapes.cell_supported(cfg, suite) == \
            ref_shapes.cell_supported(ref_cfg, ref_suite)
        assert shapes.cache_seq_len(cfg, suite) == \
            ref_shapes.cache_seq_len(ref_cfg, ref_suite)
        for ours, ref in ((shapes.batch_specs(cfg, suite),
                           ref_shapes.batch_specs(ref_cfg, ref_suite)),
                          (shapes.decode_batch_specs(cfg, suite),
                           ref_shapes.decode_batch_specs(ref_cfg, ref_suite))):
            assert sorted(ours) == sorted(ref)
            for k, spec in ours.items():
                assert spec.shape == tuple(ref[k].shape)
                assert str(spec.dtype).split(".")[-1] == str(ref[k].dtype)
                meta = spec.meta()
                assert meta.device.type == "meta" and meta.shape == spec.shape
