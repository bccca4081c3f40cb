"""The port's paged serving engine on a device mesh against the reference's.

The reference runs once for the module in a subprocess with four forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``):
this file run as a script (``--reference OUT.npz``) builds the meshes
(1, 2), (2, 1) and (2, 2) and, for reduced f32 granite-moe-1b-a400m (its
capacity lowered until a prefill chunk drops tokens) and yi-6b, runs
`prefill_chunk_paged` and `decode_step_paged` alone on pools, tables and
tokens made with numpy from a seed, then the whole `PagedServingEngine`
with the prefix cache on, under each mesh's context and without one. It
writes every result (or the refusal it raised) with its inputs and
parameters to one npz.

The port runs each mesh as gloo ranks on the CPU (`launch.mesh.spawn`, the
three meshes at once). Every rank holds the whole pools and round, as the
reference's paged path keeps them, so each rank's logits and pools are
held against the reference's whole result, in f32 within 2e-3 (the
garbage page aside, where padding rows land in any order), and each
rank's engine must give the reference's greedy tokens exactly, with the
same prefix hits, copy-on-write forks and blocks allocated.

The reference's expert-parallel shard_map splits a MoE layer's batch over
`data`, so a one-row prefill chunk on a mesh with ``data > 1`` raises
there: on (2, 1) and (2, 2) granite's chunk raises a ValueError on both
sides (the port's on every rank, before any collective) and both engines
fail every request after the same step faults. The decode round of four
rows runs on every mesh.

Ranks decide in lockstep: one test delays one rank's submissions, puts
latency faults on it alone and gives a request a deadline its clock would
read differently; both ranks must retire the same requests in the same
rounds, inside `spawn`'s timeout.
"""
import functools
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import Mesh, ShardingCtx

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
MESHES = [(1, 2), (2, 1), (2, 2)]
ARCHS = ["granite-moe-1b-a400m", "yi-6b"]
MOE_CAPACITY_FACTOR = 0.25
SPAWN_TIMEOUT_S = 240.0
REF_TIMEOUT_S = 600.0

# the steps alone: pools [L, NB, BLK, KH, D] (block 0 the garbage page),
# a decode round of B rows over tables of M blocks, and one prefill chunk
# of N_VALID tokens padded to CHUNK at START
NB, BLK, M, B = 12, 16, 3, 4
CHUNK, START, N_VALID = 32, 16, 20
# the engine: prompts as `launch.serve.serve_paged` draws them
ENGINE = dict(batch=4, prompt_len=40, gen=6, block_size=16, num_blocks=6,
              prefill_chunk=32)


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(get, arch):
    cfg = get(arch).reduced().replace(**F32)
    if cfg.moe:
        cfg = cfg.replace(capacity_factor=MOE_CAPACITY_FACTOR)
    return cfg


def _step_inputs(cfg):
    """Pools, a decode round and a prefill chunk, from a seed."""
    rng = np.random.default_rng(11)
    kh, hd = cfg.kv_heads, cfg.resolved_head_dim
    pools = rng.normal(size=(2, cfg.n_layers, NB, BLK, kh, hd)) * 0.5
    tables = np.stack([rng.permutation(np.arange(1, NB))[:M]
                       for _ in range(B)]).astype(np.int32)
    return {
        "k_pools": pools[0].astype(np.float32),
        "v_pools": pools[1].astype(np.float32),
        "tables": tables,
        "lengths": rng.integers(5, M * BLK - 1, B).astype(np.int32),
        "tokens": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
        "chunk_table": tables[:1],
        "chunk_tokens": np.pad(rng.integers(0, cfg.vocab, (1, N_VALID)),
                               ((0, 0), (0, CHUNK - N_VALID)))
        .astype(np.int32),
    }


def _engine_prompts(vocab):
    """`serve_paged`'s draws for seed 0: ragged prompts, every other one
    opening with a shared system prompt."""
    rng = np.random.default_rng(0)
    n, plen = ENGINE["batch"], ENGINE["prompt_len"]
    lo = max(1, plen // 4)
    plens = [int(x) for x in rng.integers(lo, plen + 1, n)]
    plens[int(np.argmax(plens))] = plen
    system = rng.integers(0, vocab, max(lo // 2, 1))
    out = []
    for i, p in enumerate(plens):
        body = rng.integers(0, vocab, p)
        if i % 2 == 0:
            body[: len(system)] = system[: p]
        out.append(body)
    return out


ENGINE_COUNTERS = ("completed", "failed", "step_faults", "prefix_hits",
                   "prefix_tokens", "cow_forks", "blocks_allocated",
                   "preemptions", "prefill_chunks", "round_width")


def _engine_kwargs():
    return {k: ENGINE[k] for k in ("block_size", "num_blocks",
                                   "prefill_chunk")}


def _engine_result(eng, prompts, prefix):
    rids = [eng.submit(p, max_new_tokens=ENGINE["gen"]) for p in prompts]
    stats = eng.run()
    reqs = [eng.request(r) for r in rids]
    out = {f"{prefix}/{k}": np.array(stats[k]) for k in ENGINE_COUNTERS}
    gen = np.full((len(reqs), ENGINE["gen"]), -1, np.int64)
    for i, r in enumerate(reqs):
        gen[i, :len(r.generated)] = r.generated
    out[f"{prefix}/generated"] = gen
    out[f"{prefix}/states"] = np.array([r.state.value for r in reqs])
    out[f"{prefix}/errors"] = np.array(
        [(r.error or "").split(":")[0] for r in reqs])
    return out, stats


# ------------------------------------------------------------- the reference


def _flatten(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def run_reference(out_path):
    """The reference on every mesh (four forced host devices) and on none,
    into one npz. Run as a script by the `_reference_run` fixture."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from repro.configs import get_config as ref_get_config
    from repro.models import build_model
    from repro.serve.engine import PagedServingEngine as RefEngine
    from repro.sharding import NULL_CTX as REF_NULL
    from repro.sharding import ShardingCtx as RefCtx

    assert len(jax.devices()) == 4, jax.devices()
    ctxs = {_tag(s): RefCtx(mesh=JaxMesh(np.array(
        jax.devices()[:s[0] * s[1]]).reshape(s), ("data", "model")))
        for s in MESHES}
    ctxs["single"] = REF_NULL
    out = {}
    for arch in ARCHS:
        cfg = _cfg(ref_get_config, arch)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        out.update(_flatten(params, f"params/{arch}"))
        inp = _step_inputs(cfg)
        out.update({f"inputs/{arch}/{k}": v for k, v in inp.items()})
        prompts = _engine_prompts(cfg.vocab)
        for tag, ctx in ctxs.items():
            model = build_model(cfg, ctx)
            key = f"{arch}/{tag}"
            chunk = jax.jit(model.prefill_chunk_paged)
            try:
                logits, kp, vp = chunk(
                    params, jnp.asarray(inp["k_pools"]),
                    jnp.asarray(inp["v_pools"]),
                    jnp.asarray(inp["chunk_table"]),
                    jnp.asarray(START, jnp.int32),
                    {"tokens": jnp.asarray(inp["chunk_tokens"])},
                    jnp.asarray(N_VALID, jnp.int32))
                out.update({f"{key}/chunk/logits": np.asarray(logits),
                            f"{key}/chunk/k_pools": np.asarray(kp),
                            f"{key}/chunk/v_pools": np.asarray(vp)})
            except ValueError as e:
                out[f"{key}/chunk/refused"] = np.array(str(e)[:400])
            decode = jax.jit(model.decode_step_paged)
            logits, kp, vp = decode(
                params, jnp.asarray(inp["k_pools"]),
                jnp.asarray(inp["v_pools"]), jnp.asarray(inp["tables"]),
                jnp.asarray(inp["lengths"]),
                {"tokens": jnp.asarray(inp["tokens"])})
            out.update({f"{key}/decode/logits": np.asarray(logits),
                        f"{key}/decode/k_pools": np.asarray(kp),
                        f"{key}/decode/v_pools": np.asarray(vp)})
            eng = RefEngine(cfg, ctx, params=params, **_engine_kwargs())
            out.update(_engine_result(eng, prompts, f"{key}/engine")[0])
    np.savez(out_path, **out)


# ------------------------------------------------------------------ the port


def _unflatten(npz, prefix):
    tree = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = npz[key]
    return tree


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _run_port(ctx, ref, arch, key):
    """`arch`'s steps alone and its engine under `ctx` (any context), as
    numpy keyed like the reference's npz under `key`."""
    from repro_torch import sharding
    from repro_torch.models import build_model
    from repro_torch.models.params import params_from_numpy
    from repro_torch.serve import PagedServingEngine

    cfg = _cfg(get_config, arch)
    params = params_from_numpy(_unflatten(ref, f"params/{arch}"), cfg,
                               "cpu", ctx)
    inp = {k: _t(v) for k, v in _unflatten(ref, f"inputs/{arch}").items()}
    model = build_model(cfg, ctx)
    out = {}
    kp, vp = inp["k_pools"].clone(), inp["v_pools"].clone()
    sharding.reset_collective_stats()
    try:
        logits, kp2, vp2 = model.prefill_chunk_paged(
            params, kp, vp, inp["chunk_table"],
            torch.tensor(START, dtype=torch.int32),
            {"tokens": inp["chunk_tokens"]},
            torch.tensor(N_VALID, dtype=torch.int32))
        assert kp2 is kp and vp2 is vp          # written in place
        out.update({f"{key}/chunk/logits": logits.numpy(),
                    f"{key}/chunk/k_pools": kp.numpy(),
                    f"{key}/chunk/v_pools": vp.numpy()})
    except ValueError as e:
        out[f"{key}/chunk/refused"] = np.array(str(e))
        out[f"{key}/chunk/collectives_before_refusal"] = np.array(
            sharding.collective_stats()["calls"])
    kp, vp = inp["k_pools"].clone(), inp["v_pools"].clone()
    logits, _, _ = model.decode_step_paged(
        params, kp, vp, inp["tables"], inp["lengths"],
        {"tokens": inp["tokens"]})
    out.update({f"{key}/decode/logits": logits.numpy(),
                f"{key}/decode/k_pools": kp.numpy(),
                f"{key}/decode/v_pools": vp.numpy()})
    eng = PagedServingEngine(cfg, ctx, params=params, device="cpu",
                             **_engine_kwargs())
    res, stats = _engine_result(eng, _engine_prompts(cfg.vocab),
                                f"{key}/engine")
    out.update(res)
    for k in ("mesh", "decode_captures", "prefill_captures", "held_bytes",
              "collectives", "decode_rounds"):
        out[f"{key}/stats/{k}"] = stats.get(k)
    return out


def _rank_checks(ctx, ref_path):
    """Everything one rank of a mesh computes, keyed as the reference's
    npz (without the mesh tag), plus its coordinate."""
    from repro_torch.models import moe

    repro_torch.reset()
    ref = np.load(ref_path)
    out = {"coordinate": np.array(ctx.mesh.coordinate)}
    for arch in ARCHS:
        out.update(_run_port(ctx, ref, arch, arch))
    # the chunk's dispatch on this rank drops tokens (granite's capacity)
    cfg = _cfg(get_config, ARCHS[0])
    if moe.ep_sharded(cfg, ctx) and ctx.axis_sizes["data"] == 1:
        rng = np.random.default_rng(5)
        n = ctx.axis_sizes["model"]
        xt = _t(rng.normal(size=(CHUNK // n, cfg.d_model)).astype(np.float32))
        w = _t(rng.normal(size=(cfg.d_model, cfg.n_experts))
               .astype(np.float32))
        gates, experts, _ = moe.router_topk(xt, w, cfg.top_k)
        _, meta = moe._dispatch_local(xt, gates, experts, cfg,
                                      moe._capacity(xt.shape[0], cfg))
        out["dropped"] = np.array(int((~meta["keep"]).sum()))
    return out


def _rank_lockstep(ctx, gen=12):
    """(1, 2) granite with rank 1 late to submit and slowed by latency
    faults, one request's deadline short: each request's retirement as
    (rid, round, state, reason), in order."""
    from repro_torch.models import build_model
    from repro_torch.serve import FaultInjector, PagedServingEngine

    repro_torch.reset()
    cfg = _cfg(get_config, ARCHS[0])
    g = torch.Generator()
    g.manual_seed(0)
    params = build_model(cfg, ctx).init(g, "cpu")
    late = ctx.index("model") == 1
    faults = FaultInjector(3, rates={"latency": 1.0},
                           latency_spike_s=0.01) if late else None
    retired = []
    eng = PagedServingEngine(
        cfg, ctx, params=params, device="cpu", faults=faults,
        on_finish=lambda r: retired.append(
            (r.rid, eng.rounds, r.state.value, r.finish_reason)),
        **_engine_kwargs())
    if late:
        time.sleep(0.3)       # its clock reads every deadline 0.3 s later
    for i, p in enumerate(_engine_prompts(cfg.vocab)):
        eng.submit(p, max_new_tokens=gen,
                   deadline_s={1: 0.05, 3: 60.0}.get(i))
    stats = eng.run()
    return {"retired": retired, "faults": eng.faults.injected,
            "lockstep_calls": stats["collectives"]["lockstep"]["calls"]}


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference's subprocess, started before the module's first test
    so that it runs while the tests of the port alone do."""
    out = tmp_path_factory.mktemp("mesh_paged_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--reference",
             str(out / "ref.npz")], env=env, stdout=subprocess.DEVNULL,
            stderr=err)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def ref_path(_reference_run):
    out, proc = _reference_run
    try:
        code = proc.wait(timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert code == 0, (out / "stderr.txt").read_text()[-4000:]
    return str(out / "ref.npz")


@pytest.fixture(scope="module")
def ref(ref_path):
    return np.load(ref_path)


@pytest.fixture(scope="module")
def port(ref_path):
    """mesh tag -> every rank's results, in rank order (the three meshes
    spawned at once)."""
    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {_tag(shape): pool.submit(
            spawn, functools.partial(_rank_checks, ref_path=ref_path), shape,
            device="cpu", backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
            for shape in MESHES}
        return {tag: run.result() for tag, run in runs.items()}


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL, f"{what}: max abs err {err}"


def _refused(cfg, shape):
    """Whether the reference refuses `cfg`'s one-row chunk on `shape`."""
    return cfg.moe and shape[0] > 1


def _check_step(ref, res, arch, tag, step, r):
    key = f"{arch}/{tag}/{step}"
    _close(res[f"{arch}/{step}/logits"], ref[f"{key}/logits"],
           f"rank {r} {step} logits")
    for pool in ("k_pools", "v_pools"):
        # block 0 is the garbage page, where padding rows land in any order
        _close(res[f"{arch}/{step}/{pool}"][:, 1:],
               ref[f"{key}/{pool}"][:, 1:], f"rank {r} {step} {pool}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_prefill_chunk_matches_reference(ref, port, shape, arch):
    tag = _tag(shape)
    refused = _refused(get_config(arch), shape)
    assert (f"{arch}/{tag}/chunk/refused" in ref.files) == refused
    for r, res in enumerate(port[tag]):
        if refused:
            # every rank raised, naming the mesh and the shape, before any
            # rank entered a collective
            msg = str(res[f"{arch}/chunk/refused"])
            assert "mesh" in msg and str((1, CHUNK, 64)) in msg, msg
            assert int(res[f"{arch}/chunk/collectives_before_refusal"]) == 0
            assert f"{arch}/chunk/logits" not in res
        else:
            _check_step(ref, res, arch, tag, "chunk", r)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_decode_round_matches_reference(ref, port, shape, arch):
    tag = _tag(shape)
    for r, res in enumerate(port[tag]):
        _check_step(ref, res, arch, tag, "decode", r)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_engine_matches_reference(ref, port, shape, arch):
    """Greedy tokens, terminal states and the engine's counters equal the
    reference engine's on the same mesh; where the reference refuses the
    chunk, both fail every request after the same step faults."""
    tag = _tag(shape)
    want = f"{arch}/{tag}/engine"
    for r, res in enumerate(port[tag]):
        for k in ENGINE_COUNTERS + ("generated", "states", "errors"):
            assert np.array_equal(res[f"{arch}/engine/{k}"],
                                  ref[f"{want}/{k}"]), (r, k)
    if _refused(get_config(arch), shape):
        assert set(ref[f"{want}/states"]) == {"failed"}
        assert set(ref[f"{want}/errors"]) == {"ValueError"}
    else:
        assert set(ref[f"{want}/states"]) == {"finished"}
        assert int(ref[f"{want}/prefix_hits"]) >= 1
        assert int(ref[f"{want}/cow_forks"]) >= 1


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_each_rank_holds_its_experts_and_the_whole_pools(port, single,
                                                         shape):
    """granite's experts split over `model`; every other weight and the KV
    pools whole on every rank."""
    assert single[f"{ARCHS[0]}/stats/held_bytes"]["experts"] > 0
    for res in port[_tag(shape)]:
        for arch in ARCHS:
            held = res[f"{arch}/stats/held_bytes"]
            full = single[f"{arch}/stats/held_bytes"]
            assert held["experts"] * shape[1] == full["experts"]
            assert held["params"] - held["experts"] == \
                full["params"] - full["experts"]
            assert held["kv_pools"] == full["kv_pools"]


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_engine_steps_run_eagerly_with_the_reference_collectives(port, shape):
    """On a mesh no round or chunk is captured, and the collectives are the
    reference's: one all_reduce a MoE layer a round (none on a `model` of
    one), two all_to_alls and an all_gather a MoE layer a chunk, and one
    lockstep sum (the solved depth) with no deadline."""
    tag = _tag(shape)
    for r, res in enumerate(port[tag]):
        for arch in ARCHS:
            cfg = _cfg(get_config, arch)
            mesh = res[f"{arch}/stats/mesh"]
            assert mesh["shape"] == list(shape) and mesh["rank"] == r
            assert mesh["coordinate"] == list(res["coordinate"])
            assert res[f"{arch}/stats/decode_captures"] == 0
            assert res[f"{arch}/stats/prefill_captures"] == 0
            coll = res[f"{arch}/stats/collectives"]
            rounds = res[f"{arch}/stats/decode_rounds"]
            chunks = int(res[f"{arch}/engine/prefill_chunks"])
            moe = cfg.n_layers if cfg.moe else 0
            data = 1 if shape[0] > 1 else 0   # the gather over `data`
            model = 1 if shape[1] > 1 else 0
            assert coll["decode_rounds"]["calls"] == \
                moe * (model + data) * rounds
            assert coll["prefill_chunks"]["calls"] == \
                moe * (3 * model + data) * chunks
            assert coll["lockstep"]["calls"] == 1


def test_chunk_capacity_drops_tokens(port):
    assert all(int(res["dropped"]) > 0 for res in port["1x2"])


def test_ranks_stay_in_lockstep_under_deadlines_and_latency_faults():
    """Rank 1 submits 0.3 s late and sleeps a latency fault every round;
    request 1's 50 ms deadline expires by rank 0's clock at the same round
    on both ranks, and the run ends inside the spawn's timeout."""
    t0 = time.perf_counter()
    ranks = spawn(_rank_lockstep, (1, 2), device="cpu", backend="gloo",
                  timeout_s=SPAWN_TIMEOUT_S)
    assert time.perf_counter() - t0 < SPAWN_TIMEOUT_S
    assert ranks[0]["retired"] == ranks[1]["retired"]
    reasons = {rid: reason for rid, _, _, reason in ranks[0]["retired"]}
    assert reasons == {0: "complete", 1: "deadline", 2: "complete",
                       3: "complete"}
    assert ranks[0]["faults"] == 0 and ranks[1]["faults"] > 0
    # the depth at construction, then a sum each round with a live deadline
    assert ranks[0]["lockstep_calls"] == ranks[1]["lockstep_calls"] > 1


@pytest.fixture(scope="module")
def single(ref):
    """The port's steps and engine without a mesh, on the reference's
    parameters, in this process."""
    torch.set_num_threads(1)
    out = {}
    for arch in ARCHS:
        out.update(_run_port(ShardingCtx(), ref, arch, arch))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_null_ctx_paged_path_matches_reference(ref, single, arch):
    """Without a mesh nothing changed: the steps and the engine against the
    reference's single-device ones, and no mesh in the stats."""
    res = single
    for step in ("chunk", "decode"):
        _check_step(ref, res, arch, "single", step, 0)
    for k in ENGINE_COUNTERS + ("generated", "states"):
        assert np.array_equal(res[f"{arch}/engine/{k}"],
                              ref[f"{arch}/single/engine/{k}"]), k
    assert res[f"{arch}/stats/mesh"] is None
    assert res[f"{arch}/stats/collectives"] is None


def test_serve_on_mesh_paged_engine():
    """`serve_on_mesh(..., engine="paged")`: every rank's stats, the same
    tokens and states, the mesh's figures, eager steps."""
    from repro_torch.launch.serve import serve_on_mesh

    cfg = get_config("granite-moe-1b-a400m").reduced().replace(**F32)
    stats = serve_on_mesh(cfg, (1, 2), device="cpu", backend="gloo",
                          engine="paged", batch=3, prompt_len=24, gen=3,
                          timeout_s=SPAWN_TIMEOUT_S)
    assert [st["mesh"]["rank"] for st in stats] == [0, 1]
    for st in stats:
        assert st["engine"] == "paged" and st["completed"] == 3
        assert st["decode_captures"] == st["prefill_captures"] == 0
        assert st["collectives"]["decode_rounds"]["calls"] > 0
        assert st["collectives"]["decode_rounds"]["s"] > 0   # timed
        assert st["generated"] == stats[0]["generated"]


def test_paged_mesh_cli(capsys):
    """``launch.serve --engine paged --mesh 1x2``: rank 0's stats, after
    `serve_on_mesh` held every rank's tokens and states to rank 0's."""
    import json

    from repro_torch.launch.serve import main

    stats = main(["--arch", "granite-moe-1b-a400m", "--reduced", "--engine",
                  "paged", "--mesh", "1x2", "--device", "cpu", "--backend",
                  "gloo", "--batch", "2", "--prompt-len", "20", "--gen",
                  "2"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
        json.loads(json.dumps(stats))
    assert stats["engine"] == "paged" and stats["mesh"]["rank"] == 0
    assert stats["states"] == ["finished", "finished"]


def test_paged_mesh_serve_runs_on_the_cpu_only_when_asked():
    from repro_torch.launch import serve as port_serve

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 2)))
    cfg = get_config("yi-6b").reduced().replace(**F32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.serve(cfg, batch=2, prompt_len=8, gen=2, ctx=ctx,
                         engine="paged")


def test_a_mesh_of_shapes_alone_is_refused():
    from repro_torch.serve import PagedServingEngine

    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 2)))
    cfg = get_config("yi-6b").reduced().replace(**F32)
    with pytest.raises(RuntimeError, match="running mesh"):
        PagedServingEngine(cfg, ctx, device="cpu")


if __name__ == "__main__":
    if sys.argv[1:2] != ["--reference"] or len(sys.argv) != 3:
        sys.exit("usage: test_torch_mesh_paged.py --reference OUT.npz")
    run_reference(sys.argv[2])
