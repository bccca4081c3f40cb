"""The placed serving step on a device mesh against the reference's own.

The module draws the parameters of each reduced f32 case once, with the
port's `initialize` from seed 0 (every bias and norm weight redrawn at
random, so that whisper's ``bo`` counts), and writes them with the
prompts to an npz. The reference runs in a subprocess with four forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``;
this file run as a script, ``--reference IN.npz OUT.npz``): on each mesh
(1, 2), (2, 1) and (2, 2) it puts the parameters by
``model.param_shardings()``, runs the prefill its dry-run jits (the
parameters' and the batch's shardings in, ``model.cache_shardings`` out)
and four steps of its `runtime.steps.jit_decode_step(model, shape)`,
keeping every step's logits, the caches and each cache leaf's
``sharding.spec``; and it writes the partition specs of
``param_shardings`` and ``cache_shardings`` of every shipped arch on the
three meshes and on the 16 x 16 production mesh. At the same time the
port runs each mesh as gloo ranks on the CPU (`launch.mesh.spawn`), each
rank holding its placed blocks (`Model.place`) and running
`runtime.steps.jit_prefill_step` and `jit_decode_step`, and the tests
hold, in f32 within 2e-3:

* every step's logits, greedy tokens exactly equal, and each rank's
  block of every cache leaf after the prefill and after the steps;
* the cache leaves' specs equal the reference's compiled output
  shardings, and the port's `param_shardings` / `cache_shardings` the
  reference's leaf by leaf;
* a rank holds exactly its placed share (the specs' bytes, and yi-6b,
  granite-moe, mamba2 and whisper at full width from the specs alone);
* the trouble spots: whisper's ``bo`` added once after the row-parallel
  sum, hymba's ring cache split by heads and wrapped, a cache whose
  length `model` does not divide (held by heads) and a vocabulary the
  guard leaves whole (no collective for it), GQA with a q block over one
  K/V head (paligemma);
* `sharding.shard_map` refuses a block of the wrong shape, naming it.

Every spawn has its own process-group timeout and join timeout.
"""
import functools
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import ALL_ARCH_NAMES, get_config, token_split
from repro_torch.configs.shapes import SHAPES, ShapeSuite
from repro_torch.core import tree
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model
from repro_torch.models import params as pm
from repro_torch.sharding import (Mesh, ShardingCtx, block_shape, dry_mesh,
                                  local_shard)

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
MESHES = [(1, 2), (2, 1), (2, 2)]
SPAWN_TIMEOUT_S = 240.0
REF_TIMEOUT_S = 600.0
B, STEPS = 4, 4
# name -> (arch, config overrides, prompt positions)
CASES = {
    "yi-6b": ("yi-6b", {}, 16),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, 16),
    "whisper-medium": ("whisper-medium", {}, 16),
    "mamba2-130m": ("mamba2-130m", {}, 16),
    "hymba-1.5b": ("hymba-1.5b", {}, 64),      # the ring wraps at step 1
    "paligemma-3b": ("paligemma-3b", {}, 16),
    # a cache of 19 rows (held by heads on model 2), a vocabulary of 255
    # (whole: the guard), the row-granular write
    "yi-6b-odd": ("yi-6b", {"vocab": 255, "cache_update": "row"}, 15),
}
SPEC_MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "single": (16, 16)}
SPEC_SHAPES = ("decode_32k", "long_500k")


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(get, name):
    arch, over, _ = CASES[name]
    return get(arch).reduced().replace(**F32, **over)


def _pad_to(cfg, prompt, text):
    """The cache's text rows: four steps past the prompt, or for whisper the
    encoder's length, so that one shape suite holds both its caches."""
    return prompt if cfg.enc_dec else text + STEPS


def _suite(cfg, prompt, text):
    rows = _pad_to(cfg, prompt, text) + (cfg.prefix_len if cfg.vlm else 0)
    return ShapeSuite("placed_test", rows, B, "decode")


def _flatten(node, prefix):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: node}


def _unflatten(flat, prefix):
    out = {}
    for key in flat:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]
    return out


def _norm_spec(spec):
    """A partition spec as the port writes it: one-axis tuples as the axis,
    trailing Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, (tuple, list)) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _enc_spec(spec) -> str:
    return repr(_norm_spec(spec))


def draw_inputs(path):
    """Every case's whole parameters (the port's `initialize`, seed 0, with
    each zero- or one-initialized leaf redrawn) and prompts."""
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.lm import param_specs

    arrays = {}
    for name, (_, _, prompt) in CASES.items():
        cfg = _cfg(get_config, name)
        gen = torch.Generator()
        gen.manual_seed(0)
        specs = param_specs(cfg)
        params = pm.initialize(specs, gen, "cpu")
        rng = np.random.default_rng(1)
        for s, x in zip(tree.leaves(specs), tree.leaves(params)):
            if s.init in ("zeros", "ones"):
                x.copy_(torch.from_numpy(rng.normal(
                    1.0 if s.init == "ones" else 0.0, 0.1,
                    size=s.shape).astype(np.float32)))
        arrays.update({k: v.numpy() for k, v in
                       _flatten(params, f"params/{name}").items()})
        prompts, text = make_prompts(cfg, B, prompt,
                                     np.random.default_rng(0), "cpu")
        arrays.update({f"prompts/{name}/{k}": v.numpy()
                       for k, v in prompts.items()})
        arrays[f"text/{name}"] = np.array(text)
    np.savez(path, **arrays)


# ------------------------------------------------------------- the reference


def run_reference(in_path, out_path):
    """The reference's placed prefill and `jit_decode_step` on every mesh
    (four forced host devices), and its specs, into one npz."""
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from repro.configs import get_config as ref_get_config
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro.models import build_model as ref_build
    from repro.models import params as ref_pm
    from repro.runtime import steps as ref_steps
    from repro.sharding import ShardingCtx as RefCtx

    assert len(jax.devices()) == 4, jax.devices()
    inp = np.load(in_path)
    out = {}
    meshes = {_tag(s): JaxMesh(np.array(jax.devices()[:s[0] * s[1]])
                               .reshape(s), ("data", "model"))
              for s in MESHES}
    for name, (_, _, prompt) in CASES.items():
        cfg = _cfg(ref_get_config, name)
        params = jax.tree.map(jnp.asarray, _unflatten(inp, f"params/{name}"))
        batch = {k: jnp.asarray(v) for k, v in
                 _unflatten(inp, f"prompts/{name}").items()}
        text = int(inp[f"text/{name}"])
        suite = _suite(cfg, prompt, text)
        for tag, mesh in meshes.items():
            ctx = RefCtx(mesh=mesh)
            model = ref_build(cfg, ctx)
            ps, cs = model.param_shardings(), model.cache_shardings(suite)
            placed = jax.device_put(params, ps)
            bsh = ref_steps.batch_shardings(ctx, batch)
            prefill = jax.jit(
                lambda p, b, m=model: m.prefill(
                    p, b, pad_to=_pad_to(cfg, prompt, text)),
                in_shardings=(ps, bsh), out_shardings=(cs, None))
            decode = ref_steps.jit_decode_step(model, suite)
            cache, logits = prefill(placed, batch)
            key = f"{name}/{tag}"
            out[f"{key}/prefill_logits"] = np.asarray(logits)
            for leaf, x in cache["layers"].items():
                out[f"{key}/prefill_cache/{leaf}"] = np.asarray(x)
                out[f"{key}/prefill_spec/{leaf}"] = np.array(
                    _enc_spec(x.sharding.spec))
            tokens = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            toks = [tokens]
            for step in range(STEPS):
                logits, cache = decode(placed, cache, {"tokens": tokens})
                out[f"{key}/step{step}_logits"] = np.asarray(logits)
                tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks.append(tokens)
            out[f"{key}/tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
            for leaf, x in cache["layers"].items():
                out[f"{key}/final_cache/{leaf}"] = np.asarray(x)
                out[f"{key}/final_spec/{leaf}"] = np.array(
                    _enc_spec(x.sharding.spec))
    # the specs of every shipped arch: real meshes for the small ones, the
    # production mesh as a stand-in (its axis names and device-array shape)
    for arch in ALL_ARCH_NAMES:
        cfg = ref_get_config(arch)
        for tag, shape in SPEC_MESHES.items():
            mesh = meshes.get(tag) or types.SimpleNamespace(
                axis_names=("data", "model"),
                devices=np.empty(shape, dtype=object))
            model = ref_build(cfg, RefCtx(mesh=mesh))
            if tag in meshes:
                ps = jax.tree.map(lambda s: s.spec, model.param_shardings())
            else:
                ps = model.param_partition_specs()
            for path, spec in _flatten(ps, f"specs/{arch}/{tag}/params") \
                    .items():
                out[path] = np.array(_enc_spec(spec))
            for sname in SPEC_SHAPES:
                shape_suite = REF_SHAPES[sname]
                if tag in meshes:
                    cs = jax.tree.map(lambda s: s.spec,
                                      model.cache_shardings(shape_suite))
                else:
                    cs = ref_pm.partition_specs(model.cache_specs(shape_suite),
                                                model.ctx)
                for path, spec in _flatten(
                        cs, f"specs/{arch}/{tag}/cache/{sname}").items():
                    out[path] = np.array(_enc_spec(spec))
    np.savez(out_path, **out)


# ------------------------------------------------------------------ the port


def _rank_run(ctx, in_path):
    """Every case on this rank: the placed prefill and four decode steps,
    its blocks of every output (numpy), keyed as the reference's npz."""
    from repro_torch import sharding
    from repro_torch.runtime.steps import (jit_decode_step, jit_prefill_step,
                                           local_batch)

    torch.set_num_threads(1)
    repro_torch.reset()
    inp = np.load(in_path)
    out = {"coordinate": np.array(ctx.mesh.coordinate)}
    for name, (_, _, prompt) in CASES.items():
        cfg = _cfg(get_config, name)
        model = build_model(cfg, ctx)
        whole = tree.map_tree(lambda a: torch.from_numpy(np.array(a)),
                              _unflatten(inp, f"params/{name}"))
        placed = model.place(whole)
        del whole
        out[f"{name}/param_bytes"] = np.array(sum(
            x.numel() * x.element_size() for x in tree.leaves(placed)))
        batch = local_batch(ctx, {
            k: torch.from_numpy(np.array(v)) for k, v in
            _unflatten(inp, f"prompts/{name}").items()})
        text = int(inp[f"text/{name}"])
        prefill = jit_prefill_step(model, pad_to=_pad_to(cfg, prompt, text))
        decode = jit_decode_step(model, _suite(cfg, prompt, text))
        sharding.reset_collective_stats()
        cache, logits = prefill(placed, batch)
        out[f"{name}/prefill_logits"] = logits.numpy()
        out.update({f"{name}/prefill_cache/{k}": v.numpy().copy()
                    for k, v in cache["layers"].items()})
        tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks = [tokens]
        for step in range(STEPS):
            logits, cache = decode(placed, cache, {"tokens": tokens})
            out[f"{name}/step{step}_logits"] = logits.numpy()
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tokens)
        out[f"{name}/tokens"] = torch.cat(toks, dim=1).numpy()
        out.update({f"{name}/final_cache/{k}": v.numpy()
                    for k, v in cache["layers"].items()})
        out[f"{name}/collectives"] = sharding.collective_stats()["by_kind"]
    return out


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, mesh tag -> every rank's results): the
    reference's subprocess and the port's three meshes run at once."""
    tmp = tmp_path_factory.mktemp("placed_serve")
    inp, ref_out = tmp / "inputs.npz", tmp / "ref.npz"
    draw_inputs(inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    with ThreadPoolExecutor(len(MESHES) + 1) as pool:
        ref = pool.submit(
            subprocess.run, [sys.executable, str(Path(__file__).resolve()),
                             "--reference", str(inp), str(ref_out)],
            env=env, capture_output=True, text=True, timeout=REF_TIMEOUT_S)
        ports = {_tag(shape): pool.submit(
            spawn, functools.partial(_rank_run, in_path=str(inp)), shape,
            device="cpu", backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
            for shape in MESHES}
        port = {tag: run.result() for tag, run in ports.items()}
        done = ref.result()
    assert done.returncode == 0, done.stderr[-4000:]
    return np.load(ref_out), port


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL, f"{what}: max abs err {err}"


def _rank_ctx(shape, coord):
    return ShardingCtx(mesh=dry_mesh(Mesh(("data", "model"), shape), coord))


def _block(whole, spec, shape, coord):
    """The block of the reference's whole array that the rank at `coord`
    holds under `spec`."""
    return local_shard(torch.from_numpy(np.array(whole)), spec,
                       _rank_ctx(shape, coord)).numpy()


def _rows(whole, shape, coord):
    return _block(whole, ("data",), shape, coord)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("name", list(CASES))
def test_placed_steps_match_the_references(ref, port, shape, name):
    tag = _tag(shape)
    key = f"{name}/{tag}"
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        _close(res[f"{name}/prefill_logits"],
               _rows(ref[f"{key}/prefill_logits"], shape, coord),
               f"rank {r} prefill logits")
        for step in range(STEPS):
            _close(res[f"{name}/step{step}_logits"],
                   _rows(ref[f"{key}/step{step}_logits"], shape, coord),
                   f"rank {r} step {step} logits")
        assert np.array_equal(res[f"{name}/tokens"],
                              _rows(ref[f"{key}/tokens"], shape, coord))


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("name", list(CASES))
def test_cache_blocks_carry_the_references_output_specs(ref, port, shape,
                                                        name):
    """Each rank's block of every cache leaf, after the prefill and after
    the steps, is the block of the reference's whole cache under the
    spec of the reference's compiled output sharding, which the port's
    `cache_shardings` gives too."""
    tag = _tag(shape)
    cfg = _cfg(get_config, name)
    prompt = CASES[name][2]
    suite = _suite(cfg, prompt, token_split(cfg, prompt)[1])
    model = build_model(cfg, ShardingCtx(mesh=Mesh(("data", "model"),
                                                   shape)))
    specs = model.cache_shardings(suite)["layers"]
    for stage in ("prefill", "final"):
        leaves = [k.rsplit("/", 1)[1] for k in ref.files
                  if k.startswith(f"{name}/{tag}/{stage}_cache/")]
        assert sorted(leaves) == sorted(specs)
        for leaf in leaves:
            spec = eval(str(ref[f"{name}/{tag}/{stage}_spec/{leaf}"]))
            assert specs[leaf] == spec, leaf
            whole = ref[f"{name}/{tag}/{stage}_cache/{leaf}"]
            for r, res in enumerate(port[tag]):
                coord = tuple(res["coordinate"])
                _close(res[f"{name}/{stage}_cache/{leaf}"],
                       _block(whole, spec, shape, coord),
                       f"rank {r} {stage} {leaf} under {spec}")


@pytest.mark.parametrize("shape", list(SPEC_MESHES), ids=str)
@pytest.mark.parametrize("arch", ALL_ARCH_NAMES)
def test_param_and_cache_shardings_are_the_references(ref, arch, shape):
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), SPEC_MESHES[shape]))
    model = build_model(get_config(arch), ctx)
    got = _flatten(model.param_shardings(), f"specs/{arch}/{shape}/params")
    for sname in SPEC_SHAPES:
        got.update(_flatten(model.cache_shardings(SHAPES[sname]),
                            f"specs/{arch}/{shape}/cache/{sname}"))
    want = {k: eval(str(ref[k])) for k in ref.files
            if k.startswith(f"specs/{arch}/{shape}/")}
    assert set(got) == set(want)
    for k, spec in got.items():
        assert spec == want[k], k


def test_no_mesh_has_no_shardings():
    model = build_model(get_config("yi-6b").reduced())
    assert model.param_shardings() is None
    assert model.cache_shardings(SHAPES["decode_32k"]) is None
    from repro_torch.sharding import NULL_CTX, tree_shardings
    assert tree_shardings(NULL_CTX, {"a": ("embed",)}, {"a": (4,)}) is None
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (2, 2)))
    assert tree_shardings(ctx, {"a": ("embed", "vocab")}, {"a": (4, 6)}) == \
        {"a": ("data", "model")}


# ------------------------------------------------------------------- bytes


def _placed_bytes(cfg, shape) -> int:
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), shape))
    model = build_model(cfg, ctx)
    return sum(math.prod(block_shape(s.shape, spec, ctx))
               * pm.torch_dtype(s.dtype).itemsize
               for s, spec in zip(tree.leaves(model.param_specs()),
                                  tree.leaves(model.param_shardings())))


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_placed_share(port, shape, name):
    want = _placed_bytes(_cfg(get_config, name), shape)
    for res in port[_tag(shape)]:
        assert int(res[f"{name}/param_bytes"]) == want


# a rank's placed parameter bytes at full width (the parameters as
# param_specs types them), on the production mesh and on (1, 2), (2, 1)
FULL_BYTES = {
    "yi-6b": (126_223_360, 12_122_603_520, 12_122_071_040),
    "granite-moe-1b-a400m": (38_560_768, 2_770_026_496, 2_669_256_704),
    "mamba2-130m": (25_616_832, 258_008_832, 258_474_240),
    "whisper-medium": (29_635_328, 2_059_169_792, 1_936_218_112),
}
FULL_HELD_YI = 24_244_142_080


@pytest.mark.parametrize("arch", list(FULL_BYTES))
def test_full_width_placed_bytes(arch):
    cfg = get_config(arch)
    got = tuple(_placed_bytes(cfg, shape)
                for shape in ((16, 16), (1, 2), (2, 1)))
    assert got == FULL_BYTES[arch]
    if arch == "yi-6b":
        ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 2)))
        model = build_model(cfg, ctx)
        held = sum(math.prod(block_shape(s.shape, spec, ctx))
                   * pm.torch_dtype(s.dtype).itemsize
                   for s, spec in zip(tree.leaves(model.param_specs()),
                                      tree.leaves(model.held_param_specs())))
        assert held == FULL_HELD_YI


# ------------------------------------------------------------ trouble spots


def test_whisper_bias_and_hymba_ring_are_exercised(port):
    """whisper's ``bo`` is drawn non-zero (added once after the sum over
    `model`: its logits match above); hymba's ring holds its K/V heads
    split over `model` and has wrapped (64 + 4 positions in 32 slots)."""
    cfg = _cfg(get_config, "hymba-1.5b")
    for res in port["1x2"]:
        assert res["hymba-1.5b/final_cache/k"].shape[2:4] == \
            (cfg.sliding_window, cfg.kv_heads // 2)
    whisper = port["1x2"][0]["whisper-medium/collectives"]
    assert whisper.get("all-reduce", {}).get("calls", 0) > 0


def test_a_cache_model_does_not_split_is_held_by_heads(port):
    """yi-6b-odd: 19 cache rows on model 2 -> every row, half the K/V heads
    a rank; its vocabulary of 255 stays whole, so the logits take no
    gather: the prefill's only all_gathers are the K/V heads' for the
    cache and none of [B, 1, 255] logits."""
    cfg = _cfg(get_config, "yi-6b-odd")
    for res in port["1x2"]:
        k = res["yi-6b-odd/final_cache/k"]
        assert k.shape[2:4] == (19, cfg.kv_heads // 2)
    yi = port["1x2"][0]["yi-6b/collectives"]["all-gather"]["calls"]
    odd = port["1x2"][0]["yi-6b-odd/collectives"]["all-gather"]["calls"]
    assert odd < yi


def _serve_both(ctx):
    """`serve` on the held layout and `serve_placed` from the same draw, for
    reduced f32 yi-6b and granite-moe: their tokens and the placed run's
    bytes and collectives."""
    from repro_torch.launch.serve import serve, serve_placed

    torch.set_num_threads(1)
    out = {}
    for arch in ("yi-6b", "granite-moe-1b-a400m"):
        cfg = get_config(arch).reduced().replace(**F32)
        kw = dict(batch=B, prompt_len=16, gen=5, seed=0, ctx=ctx,
                  device="cpu")
        held = serve(cfg, **kw)
        placed = serve_placed(cfg, **kw)
        out[arch] = (held["generated"], placed["generated"],
                     placed["held_bytes"]["params"], placed["collectives"])
    return out


def test_serve_placed_gives_the_held_layouts_tokens():
    """`launch.serve.serve_placed` on (2, 2) gloo ranks: the tokens of the
    held layout's `serve` from the same seed (each rank drawing its
    placed blocks of the same numbers), its placed share of the
    parameters, and its decode steps' collectives timed by kind."""
    ranks = spawn(_serve_both, (2, 2), device="cpu", backend="gloo",
                  timeout_s=SPAWN_TIMEOUT_S)
    for res in ranks:
        for arch, (held, placed, nbytes, coll) in res.items():
            assert held == placed and len(held) == B
            cfg = get_config(arch).reduced().replace(**F32)
            assert nbytes == _placed_bytes(cfg, (2, 2))
            assert coll["timed"] and all("s" in k for k in
                                         coll["by_kind"].values())


def test_serve_placed_runs_on_the_cpu_only_when_asked():
    from repro_torch.launch.serve import serve_placed

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 2)))
    cfg = get_config("yi-6b").reduced().replace(**F32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_placed(cfg, batch=2, prompt_len=8, gen=2, ctx=ctx)


def test_shard_map_refuses_a_block_of_the_wrong_shape():
    from repro_torch.sharding import shard_map

    ctx = _rank_ctx((1, 2), (0, 1))
    fn = shard_map(lambda cache, q: cache.sum() + q.sum(), ctx=ctx,
                   in_specs=((None, "model"), ()), out_specs=())
    good = torch.zeros(2, 8, device="meta")
    fn(good, torch.zeros(3, device="meta"), whole=((None, 16), None))
    with pytest.raises(ValueError, match="'cache'"):
        fn(torch.zeros(2, 16, device="meta"), torch.zeros(3, device="meta"),
           whole=((None, 16), None))


if __name__ == "__main__":
    if sys.argv[1:2] != ["--reference"] or len(sys.argv) != 4:
        sys.exit("usage: test_torch_mesh_placed_serve.py --reference IN.npz "
                 "OUT.npz")
    run_reference(sys.argv[2], sys.argv[3])
