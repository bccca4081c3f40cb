"""The port's paged serving engine against the JAX reference's.

Both engines get the same parameters (the reference's `model.init`, bridged
through numpy), the same prompts — half of them sharing a system prefix —
and the same pinned round width, in f32 on the CPU. Greedy token streams
must be identical, for a dense and a MoE arch, as must the prefix-cache,
copy-on-write and preemption counters; a seeded chaos run must end every request in the same state for
the same reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import lm as ref_lm
from repro.serve import FaultInjector as RefFaultInjector
from repro.serve import PagedServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import FaultInjector, PagedServingEngine


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


F32 = dict(dtype="float32", param_dtype="float32")


def _setup(seed=0, arch="yi-6b"):
    ref_cfg = ref_get_config(arch).reduced().replace(**F32)
    cfg = get_config(arch).reduced().replace(**F32)
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, cfg, ref_params, params


def _prompts(rng, vocab, n, lo, hi):
    """Ragged prompts; every other one opens with a shared system prefix."""
    system = rng.integers(0, vocab, lo // 2 + 3)
    out = []
    for i in range(n):
        body = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        if i % 2 == 0:
            body[: len(system)] = system[: len(body)]
        out.append(body)
    return out


def _run(engine, prompts, gen):
    rids = [engine.submit(p, max_new_tokens=gen) for p in prompts]
    stats = engine.run()
    reqs = [engine.request(r) for r in rids]
    return stats, [list(r.generated) for r in reqs], \
        [(r.state.value, r.finish_reason) for r in reqs]


COUNTERS = ("completed", "prefix_hits", "prefix_tokens", "blocks_shared",
            "cow_forks", "preemptions", "rounds", "prefill_chunks",
            "cache_evictions", "blocks_allocated")


def test_engine_tokens_and_counters_match_reference():
    ref_cfg, cfg, ref_params, params = _setup()
    prompts = _prompts(np.random.default_rng(4), cfg.vocab, 6, 6, 18)
    kw = dict(block_size=4, num_blocks=9, max_in_flight=3, prefill_chunk=8)
    ref_stats, ref_toks, ref_states = _run(
        RefEngine(ref_cfg, params=ref_params, **kw), prompts, 6)
    stats, toks, states = _run(
        PagedServingEngine(cfg, params=params, device="cpu", **kw), prompts, 6)
    assert toks == ref_toks
    assert states == ref_states == [("finished", "complete")] * 6
    for k in COUNTERS:
        assert stats[k] == ref_stats[k], k
    assert stats["prefix_hits"] > 0 and stats["cow_forks"] > 0
    assert stats["preemptions"] > 0
    assert launch_counts()["paged_decode"] == 0   # CPU: the plain version ran


def test_engine_chaos_replay_matches_reference():
    """One fault seed, both engines: every request reaches the same
    terminal state for the same reason, with the same tokens."""
    ref_cfg, cfg, ref_params, params = _setup(1)
    prompts = _prompts(np.random.default_rng(5), cfg.vocab, 6, 5, 18)
    kw = dict(block_size=4, num_blocks=14, max_in_flight=3, prefill_chunk=8)
    ref_stats, ref_toks, ref_states = _run(
        RefEngine(ref_cfg, params=ref_params, faults=RefFaultInjector(3),
                  **kw), prompts, 5)
    inj = FaultInjector(3)
    stats, toks, states = _run(
        PagedServingEngine(cfg, params=params, faults=inj, device="cpu", **kw),
        prompts, 5)
    assert states == ref_states
    assert toks == ref_toks
    for k in ("faults_injected", "step_faults", "stalls", "failed",
              "cancelled", "completed", "preemptions"):
        assert stats[k] == ref_stats[k], k
    assert inj.injected > 0


def test_engine_matches_reference_dense_generation():
    """One request through the port's paged engine equals the reference's
    dense prefill + decode_step loop token for token (f32)."""
    ref_cfg, cfg, ref_params, params = _setup()
    rng = np.random.default_rng(1)
    model = ref_build_model(ref_cfg)
    prompt = rng.integers(0, cfg.vocab, 12)
    gen = 6
    cache, logits = model.prefill(
        ref_params, {"tokens": jnp.asarray([prompt], jnp.int32)},
        pad_to=12 + gen)
    tok = int(jnp.argmax(logits[0, -1]))
    dense = [tok]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(
            ref_params, cache, {"tokens": jnp.asarray([[tok]], jnp.int32)})
        tok = int(jnp.argmax(logits[0, -1]))
        dense.append(tok)

    eng = PagedServingEngine(cfg, block_size=4, num_blocks=16, params=params,
                             device="cpu")
    rid = eng.submit(prompt, max_new_tokens=gen)
    stats = eng.run()
    assert eng.request(rid).generated == dense
    assert stats["completed"] == 1 and stats["device"] == "cpu"


def test_engine_needs_a_device_it_can_use():
    cfg = get_config("yi-6b").reduced().replace(**F32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServingEngine(cfg, block_size=4, num_blocks=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServingEngine(cfg, block_size=4, num_blocks=8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServingEngine(get_config("granite-moe-1b-a400m").reduced(),
                           block_size=4, num_blocks=8)
    with pytest.raises(ValueError):      # recurrent state: not a paged arch
        PagedServingEngine(get_config("mamba2-130m").reduced(),
                           block_size=4, num_blocks=8, device="cpu")


def test_moe_engine_tokens_match_reference():
    """The reduced granite-moe engine (MoE FFN through the grouped matmul's
    plain version) against the reference's engine, f32: identical greedy
    tokens and counters."""
    ref_cfg, cfg, ref_params, params = _setup(2, arch="granite-moe-1b-a400m")
    prompts = _prompts(np.random.default_rng(6), cfg.vocab, 5, 6, 18)
    kw = dict(block_size=4, num_blocks=12, max_in_flight=3, prefill_chunk=8)
    ref_stats, ref_toks, ref_states = _run(
        RefEngine(ref_cfg, params=ref_params, **kw), prompts, 6)
    stats, toks, states = _run(
        PagedServingEngine(cfg, params=params, device="cpu", **kw), prompts, 6)
    assert toks == ref_toks
    assert states == ref_states == [("finished", "complete")] * 5
    for k in COUNTERS:
        assert stats[k] == ref_stats[k], k
    assert launch_counts()["moe_gmm"] == 0        # CPU: the plain version ran


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(REF_REGISTRY))
def test_supports_paged_decode_matches_reference(arch, reduced):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if reduced:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    want = ref_lm.supports_paged_decode(ref_cfg)
    assert build_model(cfg).supports_paged_decode() == want
    if want:                        # the engine takes what the model serves
        PagedServingEngine(cfg.reduced().replace(**F32), block_size=4,
                           num_blocks=4, device="cpu")


def _spy_rebuilds(engine):
    """Record (round, table width, _decode_fresh) whenever the engine's
    `_decode` builds a new round step: the reference's new jitted round,
    the port's new capture on the card."""
    log = []
    build = engine._decode

    def spy(table_width):
        before = engine._decode_fn
        fn = build(table_width)
        if fn is not before:
            log.append((engine.rounds, table_width, engine._decode_fresh))
        return fn

    engine._decode = spy
    return log


def test_engine_capture_keys_follow_the_reference_recompiles():
    """One workload whose table width falls (the long requests finish
    first) and rises again (a long request arrives later): the port's round
    step is rebuilt, which is a new capture on the card, on exactly the
    rounds and at the widths where the reference builds a new jitted
    round, and every rebuild sets `_decode_fresh`."""
    ref_cfg, cfg, ref_params, params = _setup(3)
    rng = np.random.default_rng(7)
    long_ = [rng.integers(0, cfg.vocab, 24) for _ in range(3)]
    short = [rng.integers(0, cfg.vocab, 2) for _ in range(3)]
    kw = dict(block_size=4, num_blocks=24, max_in_flight=3, prefill_chunk=8)
    logs, tokens = [], []
    for engine in (RefEngine(ref_cfg, params=ref_params, **kw),
                   PagedServingEngine(cfg, params=params, device="cpu",
                                      **kw)):
        log = _spy_rebuilds(engine)
        rids = [engine.submit(p, max_new_tokens=2) for p in long_[:2]]
        rids += [engine.submit(p, max_new_tokens=10) for p in short]
        engine.run()
        rids.append(engine.submit(long_[2], max_new_tokens=2))
        engine.run()
        assert not engine._decode_fresh          # consumed by its round
        logs.append(log)
        tokens.append([list(engine.request(r).generated) for r in rids])
    assert tokens[1] == tokens[0]
    assert logs[1] == logs[0]
    widths = [w for _, w, _ in logs[1]]
    assert len(widths) >= 3 and min(widths) < widths[0] < max(widths[1:]) + 1
    assert all(fresh for _, _, fresh in logs[1])


def _spy_prefill_builds(engine):
    """Record (round, (padded, table width)) whenever the prefiller builds
    the chunk step of a new key: the reference's new jitted chunk step
    (`ChunkedPrefiller._fn`), the port's new `StepGraph` (`_graph`), which
    is a new capture on the card."""
    pre = engine.prefiller
    log = []
    if isinstance(engine, RefEngine):
        build = pre._fn

        def spy(padded, width):
            if (padded, width) not in pre._fns:
                log.append((engine.rounds, (padded, width)))
            return build(padded, width)

        pre._fn = spy
    else:
        build = pre._graph

        def spy(key):
            if key not in pre.graphs:
                log.append((engine.rounds, key))
            return build(key)

        pre._graph = spy
    return log


def test_prefill_capture_keys_follow_the_reference_compiles():
    """The workload of the decode test above, whose table width falls and
    rises, with prompts that end in chunks of 8 and of 4 (padded to the
    block): the port's prefiller builds a chunk step (a capture on the
    card) at the same rounds and (padded, table width) keys, in the same
    order, as the reference jits one, keeps every one it built, and the
    greedy tokens are identical."""
    ref_cfg, cfg, ref_params, params = _setup(3)
    rng = np.random.default_rng(7)
    long_ = [rng.integers(0, cfg.vocab, n) for n in (24, 21, 22)]
    short = [rng.integers(0, cfg.vocab, 2) for _ in range(3)]
    kw = dict(block_size=4, num_blocks=24, max_in_flight=3, prefill_chunk=8)
    logs, tokens, chunks = [], [], []
    for engine in (RefEngine(ref_cfg, params=ref_params, **kw),
                   PagedServingEngine(cfg, params=params, device="cpu",
                                      **kw)):
        log = _spy_prefill_builds(engine)
        rids = [engine.submit(p, max_new_tokens=2) for p in long_[:2]]
        rids += [engine.submit(p, max_new_tokens=10) for p in short]
        engine.run()
        rids.append(engine.submit(long_[2], max_new_tokens=2))
        engine.run()
        logs.append(log)
        tokens.append([list(engine.request(r).generated) for r in rids])
        chunks.append(engine.prefiller.chunks_run)
    assert tokens[1] == tokens[0]
    assert logs[1] == logs[0] and chunks[1] == chunks[0]
    keys = [k for _, k in logs[1]]
    assert len(set(keys)) == len(keys)            # each key built once
    assert {p for p, _ in keys} >= {4, 8}         # two padded lengths
    widths = [w for _, w in keys]
    assert min(widths) < widths[0] and widths[-1] > min(widths)  # fell, rose
    assert chunks[1] > len(keys)                  # later chunks reuse a step
