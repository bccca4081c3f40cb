"""The port's serving path on a device mesh against the reference's.

The reference runs once for the module in a subprocess with four forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``):
this file run as a script (``--reference OUT.npz``) builds its meshes
(1, 2), (2, 1) and (2, 2), runs them on inputs made with numpy from a seed
and writes every result, with the inputs and its reduced models'
parameters, to one npz. The port then runs each mesh as gloo ranks on the
CPU (`launch.mesh.spawn`: one process a rank; a rank function of this
module loads the npz, takes its shard of every input and returns its
shard of every output), and the tests hold each rank's shard against the
same block of the reference's whole result, in f32 within 2e-3:

* `flash_decode_attention`: the cache write with update "full" and "row"
  (the two leave equal caches), `pos` in shard 0, in shard 1 and at
  S - 1, a length that does not split (S % n != 0), a cross read
  (update=False); a call with every shard past `pos` gives 0, finite;
* `moe_ep_a2a` with `capacity_factor` lowered until tokens drop, and
  `moe_ep_replicated`, outputs and the aux loss;
* reduced yi-6b, granite-moe-1b-a400m and whisper-medium through
  `Model.prefill` and four `decode_step`s under the mesh's context:
  prefill logits, each rank's cache shards after prefill and after the
  steps, every step's logits, and greedy tokens exactly equal to the
  reference's on the same mesh and on ``mesh_by_name("mini")`` (the
  (2, 2) mesh of four devices);
* `serve(..., ctx=...)` end to end: every request finishes and the first
  request's tokens equal the reference `serve`'s ``sample_tokens`` on the
  mini mesh.

Every spawn has its own process-group timeout and join timeout, so a
failing rank fails its test instead of hanging it.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import Mesh, ShardingCtx, local_shard

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
MESHES = [(1, 2), (2, 1), (2, 2)]
SPAWN_TIMEOUT_S = 180.0
REF_TIMEOUT_S = 600.0

# decode attention: (name, S, pos, update, update_mode); the inputs are
# drawn from the seed of the name's first part, the same for a full/row pair
B, H, KH, D = 4, 4, 2, 16
ATTN_CASES = [
    ("shard0_full", 16, 3, True, "full"),
    ("shard0_row", 16, 3, True, "row"),
    ("shard1_full", 16, 11, True, "full"),
    ("shard1_row", 16, 11, True, "row"),
    ("last_full", 16, 15, True, "full"),
    ("last_row", 16, 15, True, "row"),
    ("odd_len", 15, 9, True, "row"),
    ("cross", 16, 15, False, "full"),
]
SEEDS = {"shard0": 100, "shard1": 101, "last": 102, "odd": 103, "cross": 104,
         "empty": 105}
# the MoE layer: reduced granite-moe with a capacity that drops tokens
MOE_ARCH = "granite-moe-1b-a400m"
MOE_B, MOE_S, MOE_CAPACITY_FACTOR = 4, 32, 0.25
# the models: batch, prompt positions, decode steps (pad_to = text + STEPS)
ARCHS = ["yi-6b", "granite-moe-1b-a400m", "whisper-medium"]
MODEL_B, MODEL_PROMPT, STEPS = 4, 16, 4


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _attn_inputs(name, s):
    rng = np.random.default_rng(SEEDS[name.split("_")[0]])
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return f(B, 1, H, D), f(B, s, KH, D), f(B, s, KH, D), f(B, 1, KH, D), \
        f(B, 1, KH, D)


def _moe_inputs(cfg):
    rng = np.random.default_rng(7)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": rng.normal(size=(d, e)) * 0.5,
         "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    x = rng.normal(size=(MOE_B, MOE_S, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def _moe_cfg(get):
    return get(MOE_ARCH).reduced().replace(
        capacity_factor=MOE_CAPACITY_FACTOR, **F32)


# ------------------------------------------------------------- the reference


def _flatten(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def run_reference(out_path):
    """The reference on every mesh (four forced host devices), into one
    npz. Run as a script by the `ref` fixture."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from repro.configs import get_config as ref_get_config
    from repro.launch import serve as ref_serve
    from repro.launch.mesh import mesh_by_name
    from repro.models import build_model
    from repro.models import common as ref_common
    from repro.models import moe as ref_moe
    from repro.sharding import ShardingCtx as RefCtx

    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    # (2, 2) is `mesh_by_name("mini")` on four devices
    meshes = {_tag(s): JaxMesh(np.array(jax.devices()[:s[0] * s[1]])
                               .reshape(s), ("data", "model"))
              for s in MESHES[:2]}
    meshes["2x2"] = mesh_by_name("mini")
    assert dict(zip(meshes["2x2"].axis_names,
                    meshes["2x2"].devices.shape)) == {"data": 2, "model": 2}
    for tag, mesh in meshes.items():
        ctx = RefCtx(mesh=mesh)
        for name, s, pos, update, mode in ATTN_CASES:
            # jitted: shard_map runs op by op (seconds a call) when eager
            attend = jax.jit(functools.partial(
                ref_common.flash_decode_attention, ctx, update=update,
                update_mode=mode))
            o, k2, v2 = attend(*map(jnp.asarray, _attn_inputs(name, s)),
                               jnp.asarray(pos, jnp.int32))
            for key, val in (("out", o), ("k", k2), ("v", v2)):
                out[f"attn/{tag}/{name}/{key}"] = np.asarray(val)
        cfg = _moe_cfg(ref_get_config)
        p, x = _moe_inputs(cfg)
        p = {k: jnp.asarray(v) for k, v in p.items()}
        y, aux = jax.jit(lambda p, x: ref_moe.moe_ep_a2a(p, x, cfg, ctx))(
            p, jnp.asarray(x))
        out[f"moe/{tag}/a2a/y"], out[f"moe/{tag}/a2a/aux"] = \
            np.asarray(y), np.asarray(aux)
        y, aux = jax.jit(lambda p, x: ref_moe.moe_ep_replicated(
            p, x, cfg, ctx))(p, jnp.asarray(x[:, :3]))
        out[f"moe/{tag}/replicated/y"], out[f"moe/{tag}/replicated/aux"] = \
            np.asarray(y), np.asarray(aux)
    for arch in ARCHS:
        cfg = ref_get_config(arch).reduced().replace(**F32)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        out.update(_flatten(params, f"params/{arch}"))
        prompts, text = ref_serve.make_prompts(
            cfg, MODEL_B, MODEL_PROMPT, np.random.default_rng(0))
        prompts = {k: v for k, v in prompts.items() if k != "positions"}
        out.update(_flatten(prompts, f"prompts/{arch}"))
        for tag, mesh in meshes.items():
            model = build_model(cfg, RefCtx(mesh=mesh))
            prefill = jax.jit(lambda p, b, m=model: m.prefill(
                p, b, pad_to=text + STEPS))
            decode = jax.jit(model.decode_step)
            cache, logits = prefill(params, prompts)
            key = f"model/{arch}/{tag}"
            out[f"{key}/prefill_logits"] = np.asarray(logits)
            out.update(_flatten(cache["layers"], f"{key}/prefill_cache"))
            tokens = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            toks = [tokens]
            for step in range(STEPS):
                logits, cache = decode(params, cache, {"tokens": tokens})
                out[f"{key}/step{step}_logits"] = np.asarray(logits)
                tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks.append(tokens)
            out[f"{key}/tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
            out.update(_flatten(cache["layers"], f"{key}/final_cache"))
        stats = ref_serve.serve(cfg, batch=MODEL_B, prompt_len=MODEL_PROMPT,
                                gen=STEPS, seed=0,
                                ctx=RefCtx(mesh=meshes["2x2"]))
        out[f"serve/{arch}/sample_tokens"] = np.asarray(stats["sample_tokens"])
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


def _rank_checks(ctx, ref_path):
    """Everything one rank of a mesh computes: its shard of every output
    (numpy), keyed as the reference's npz."""
    from repro_torch.launch import serve as port_serve
    from repro_torch.models import build_model, common, moe
    from repro_torch.models.params import params_from_numpy

    repro_torch.reset()
    ref = np.load(ref_path)
    out = {"coordinate": np.array(ctx.mesh.coordinate)}
    n_model = ctx.axis_sizes["model"]
    bspec = ctx.spec(("batch",), (B,))
    for name, s, pos, update, mode in ATTN_CASES:
        q, kc, vc, nk, nv = map(_t, _attn_inputs(name, s))
        cspec = ctx.spec(("batch", "kv_seq"), (B, s))
        kc, vc = (local_shard(c, cspec, ctx).clone() for c in (kc, vc))
        q, nk, nv = (local_shard(t, bspec, ctx) for t in (q, nk, nv))
        o, k2, v2 = common.flash_decode_attention(
            ctx, q, kc, vc, nk, nv, torch.tensor(pos, dtype=torch.int32),
            update=update, update_mode=mode, s_total=s)
        assert k2 is kc and v2 is vc          # written in place
        out.update({f"attn/{name}/out": o.numpy(), f"attn/{name}/k": k2.numpy(),
                    f"attn/{name}/v": v2.numpy()})
    # every shard past pos: no key anywhere, the merge gives 0, finite
    q, kc, vc, _, _ = map(_t, _attn_inputs("empty", 16))
    cspec = ctx.spec(("batch", "kv_seq"), (B, 16))
    o, _, _ = common._decode_core(
        ctx, local_shard(q, bspec, ctx), local_shard(kc, cspec, ctx),
        local_shard(vc, cspec, ctx), None, None,
        torch.tensor(-1, dtype=torch.int32), s_local=16 // n_model,
        update=False)
    out["attn/empty/out"] = o.numpy()

    cfg = _moe_cfg(get_config)
    p, x = _moe_inputs(cfg)
    p = {k: local_shard(_t(v), moe.EXPERT_SPECS[k], ctx).clone()
         for k, v in p.items()}
    xs = local_shard(_t(x), bspec, ctx)
    y, aux = moe.moe_ep_a2a(p, xs, cfg, ctx)
    out["moe/a2a/y"], out["moe/a2a/aux"] = y.numpy(), aux.numpy()
    sl = MOE_S // n_model
    xt = xs[:, ctx.index("model") * sl:][:, :sl].reshape(-1, cfg.d_model)
    gates, experts, _ = moe.router_topk(xt, p["router"], cfg.top_k)
    _, meta = moe._dispatch_local(xt, gates, experts, cfg,
                                  moe._capacity(xt.shape[0], cfg))
    out["moe/a2a/dropped"] = np.array(int((~meta["keep"]).sum()))
    y, aux = moe.moe_ep_replicated(p, xs[:, :3], cfg, ctx)
    out["moe/replicated/y"], out["moe/replicated/aux"] = y.numpy(), aux.numpy()

    for arch in ARCHS:
        cfg = get_config(arch).reduced().replace(**F32)
        params = params_from_numpy(_unflatten(ref, f"params/{arch}"), cfg,
                                   "cpu", ctx)
        prompts = {k: local_shard(_t(v), ctx.spec(("batch",), v.shape), ctx)
                   for k, v in _unflatten(ref, f"prompts/{arch}").items()}
        model = build_model(cfg, ctx)
        text = prompts["tokens"].shape[1]
        cache, logits = model.prefill(params, prompts, pad_to=text + STEPS)
        key = f"model/{arch}"
        out[f"{key}/prefill_logits"] = logits.numpy()
        out.update({f"{key}/prefill_cache/{k}": v.numpy().copy()
                    for k, v in cache["layers"].items()})
        tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks = [tokens]
        for step in range(STEPS):
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": tokens})
            out[f"{key}/step{step}_logits"] = logits.numpy()
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tokens)
        out[f"{key}/tokens"] = torch.cat(toks, dim=1).numpy()
        out.update({f"{key}/final_cache/{k}": v.numpy()
                    for k, v in cache["layers"].items()})
        stats = port_serve.serve(cfg, batch=MODEL_B, prompt_len=MODEL_PROMPT,
                                 gen=STEPS, seed=0, ctx=ctx, device="cpu",
                                 params=params)
        out[f"serve/{arch}/generated"] = np.array(stats["generated"])
        out[f"serve/{arch}/held_bytes"] = stats["held_bytes"]
        out[f"serve/{arch}/decode_captures"] = stats["decode_captures"]
    return out


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--reference",
         str(path)], env=env, capture_output=True, text=True,
        timeout=REF_TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-4000:]
    return str(path)


@pytest.fixture(scope="module")
def ref(ref_path):
    return np.load(ref_path)


@pytest.fixture(scope="module")
def port(ref_path):
    """mesh tag -> every rank's results, in rank order."""
    return {_tag(shape): spawn(functools.partial(_rank_checks,
                                                 ref_path=ref_path),
                               shape, device="cpu", backend="gloo",
                               timeout_s=SPAWN_TIMEOUT_S)
            for shape in MESHES}


def _block(whole, coord, shape, dims):
    """The block of the reference's whole array that the rank at `coord`
    holds: dims maps an array dim to the mesh axis that splits it."""
    for dim, axis in dims.items():
        n = shape[axis]
        size = whole.shape[dim] // n
        whole = np.take(whole, range(coord[axis] * size,
                                     (coord[axis] + 1) * size), axis=dim)
    return whole


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL, f"{what}: max abs err {err}"


DATA, MODEL = 0, 1


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: c[0])
def test_flash_decode_attention_matches_reference(ref, port, shape, case):
    name, s, _, _, _ = case
    tag = _tag(shape)
    split = s % shape[MODEL] == 0
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        want = ref[f"attn/{tag}/{name}/out"]
        _close(res[f"attn/{name}/out"], _block(want, coord, shape, {0: DATA}),
               f"rank {r} out")
        for key in ("k", "v"):
            dims = {0: DATA, 1: MODEL} if split else {0: DATA}
            _close(res[f"attn/{name}/{key}"],
                   _block(ref[f"attn/{tag}/{name}/{key}"], coord, shape, dims),
                   f"rank {r} {key} cache")


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_row_and_full_cache_writes_are_equal(port, shape):
    for res in port[_tag(shape)]:
        for where in ("shard0", "shard1", "last"):
            for key in ("k", "v", "out"):
                assert np.array_equal(res[f"attn/{where}_row/{key}"],
                                      res[f"attn/{where}_full/{key}"])


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_decode_with_every_shard_empty_is_zero(port, shape):
    for res in port[_tag(shape)]:
        out = res["attn/empty/out"]
        assert np.isfinite(out).all() and not out.any()


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("backend", ["a2a", "replicated"])
def test_moe_expert_parallel_matches_reference(ref, port, shape, backend):
    tag = _tag(shape)
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        _close(res[f"moe/{backend}/y"],
               _block(ref[f"moe/{tag}/{backend}/y"], coord, shape, {0: DATA}),
               f"rank {r} y")
        _close(res[f"moe/{backend}/aux"], ref[f"moe/{tag}/{backend}/aux"],
               f"rank {r} aux")


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_capacity_drops_tokens(port, shape):
    assert all(int(res["moe/a2a/dropped"]) > 0 for res in port[_tag(shape)])


def _cache_dims(key, s_total, shape):
    """The dims of a stacked cache leaf [L, B, S, ...] split on a mesh."""
    split = key in ("k", "v", "cross_k", "cross_v") \
        and s_total % shape[MODEL] == 0
    return {1: DATA, 2: MODEL} if split else {1: DATA}


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_matches_reference(ref, port, shape, arch):
    tag, key = _tag(shape), f"model/{arch}"
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        _close(res[f"{key}/prefill_logits"],
               _block(ref[f"{key}/{tag}/prefill_logits"], coord, shape,
                      {0: DATA}), f"rank {r} prefill logits")
        for stage in ("prefill_cache", "final_cache"):
            names = [k for k in ref.files
                     if k.startswith(f"{key}/{tag}/{stage}/")]
            assert names
            for name in names:
                leaf = name.rsplit("/", 1)[1]
                whole = ref[name]
                _close(res[f"{key}/{stage}/{leaf}"],
                       _block(whole, coord, shape,
                              _cache_dims(leaf, whole.shape[2], shape)),
                       f"rank {r} {stage} {leaf}")


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_decode_matches_reference(ref, port, shape, arch):
    tag, key = _tag(shape), f"model/{arch}"
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        for step in range(STEPS):
            _close(res[f"{key}/step{step}_logits"],
                   _block(ref[f"{key}/{tag}/step{step}_logits"], coord, shape,
                          {0: DATA}), f"rank {r} step {step} logits")
        for ref_tag in (tag, "2x2"):   # 2x2: the mini mesh
            want = _block(ref[f"{key}/{ref_tag}/tokens"], coord, shape,
                          {0: DATA})
            assert np.array_equal(res[f"{key}/tokens"], want), ref_tag


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_the_mesh_matches_reference(ref, port, shape, arch):
    want = ref[f"serve/{arch}/sample_tokens"]
    ranks = port[_tag(shape)]
    for res in ranks:
        generated = res[f"serve/{arch}/generated"]
        assert generated.shape == (MODEL_B, STEPS)   # every request finished
        assert np.array_equal(generated, ranks[0][f"serve/{arch}/generated"])
        assert np.array_equal(generated[0, :len(want)], want)
        assert res[f"serve/{arch}/decode_captures"] == 0


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_each_rank_holds_its_share(port, shape):
    """granite-moe's experts split over `model`, the KV caches (20 rows,
    whisper's 12 and its 16 cross rows) over `data` and `model`, every
    other weight whole on every rank."""
    base = port["2x1"][0]   # model 1: every expert, half the batch's caches
    for res in port[_tag(shape)]:
        for arch in ARCHS:
            held = res[f"serve/{arch}/held_bytes"]
            full = base[f"serve/{arch}/held_bytes"]
            assert held["experts"] * shape[MODEL] == full["experts"]
            assert held["params"] - held["experts"] == \
                full["params"] - full["experts"]
            assert held["kv_cache"] * shape[DATA] * shape[MODEL] == \
                full["kv_cache"] * 2


# ----------------------------------------------- the launcher and refusals


def _raise_on_rank_one(ctx):
    if ctx.index("model") == 1:
        raise ValueError("rank one fails")
    import torch.distributed as dist
    dist.barrier()


def _sleep(ctx):
    import time
    time.sleep(60)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank one fails"):
        spawn(_raise_on_rank_one, (1, 2), device="cpu", backend="gloo",
              timeout_s=60)


def test_a_hung_mesh_times_out():
    with pytest.raises(TimeoutError):
        spawn(_sleep, (1, 2), device="cpu", backend="gloo", timeout_s=3)


def test_nccl_is_refused_for_more_ranks_than_cards():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="nccl needs one card a rank"):
        spawn(_sleep, (1, cards + 1), device="cuda" if cards else "cpu",
              backend="nccl")


def test_mesh_serve_runs_on_the_cpu_only_when_asked():
    from repro_torch.launch import serve as port_serve

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 2)))
    cfg = get_config("yi-6b").reduced().replace(**F32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.serve(cfg, batch=2, prompt_len=8, gen=2, ctx=ctx)


def test_paged_engine_and_training_refuse_a_mesh():
    from repro_torch.launch import serve as port_serve
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import jit_train_step

    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 2)))
    cfg = get_config("yi-6b").reduced().replace(**F32)
    # the paged engine and training take a mesh that runs
    # (tests/test_torch_mesh_paged.py, tests/test_torch_mesh_train.py), not
    # one of shapes alone
    for call in (
            lambda: port_serve.serve(cfg, batch=2, prompt_len=8, gen=2,
                                     ctx=ctx, engine="paged", device="cpu"),
            lambda: port_serve.serve_paged(cfg, batch=2, prompt_len=8, gen=2,
                                           ctx=ctx, device="cpu")):
        with pytest.raises(RuntimeError, match="running mesh"):
            call()
    with pytest.raises(RuntimeError, match="running mesh"):
        jit_train_step(build_model(cfg, ctx), AdamWConfig())


if __name__ == "__main__":
    if sys.argv[1:2] != ["--reference"] or len(sys.argv) != 3:
        sys.exit("usage: test_torch_mesh_serve.py --reference OUT.npz")
    run_reference(sys.argv[2])
