"""The train state placed by its rules on a device mesh, against the
reference's own placed step.

The module draws the parameters of each reduced f32 model (granite-moe
with a capacity factor that drops tokens, yi-6b, mamba2-130m; yi-6b with
6 heads over 3 K/V heads, which `model` 2 does not divide, so that a
rank's block of q heads projects only the span of K/V heads it reads;
hymba-1.5b's hybrid heads, whisper-medium's encoder and cross-attention
on frame embeddings, paligemma-3b's prefix of patch embeddings) once,
with the port's `initialize` from seed 0, and writes them to an npz. The
reference runs in a subprocess with four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``; this file run as
a script, ``--reference PARAMS.npz OUT.npz``): on each mesh (1, 2), (2, 1)
and (2, 2) it puts the train state by ``jax.device_put(state,
state_shardings(model))`` and takes three steps of its
`runtime.steps.jit_train_step` (placed in and out, so the step does not
recompile on its own output; granite on (2, 2) also at ``accum=2``;
whisper one step, `STEPS_OF`),
keeping each step's metrics, the state after them and every output
leaf's ``sharding.spec``. At the same time the port runs each mesh as
gloo ranks on the CPU from the same parameters, each rank holding its
placed blocks (`Model.place`), and the tests hold, in f32 within 2e-3:

* each step's loss, learning rate and gradient norm (granite's and
  paligemma's first only, whisper's within 2e-3 of it), and each rank's
  block of every leaf of params, mu and nu after the steps;
* the reference's output specs equal the port's `state_shardings`, leaf
  by leaf;
* a rank holds exactly the specs' share of params, mu and nu (and, at
  full width from the specs alone, granite-moe f32 on (2, 1) 2.669 GB of
  5.339 a rank, yi-6b on (2, 2) 6.061 of 24.244);
* the blocks a spec replicates over an axis are bitwise equal across it;
* the gathers and reductions cut into buckets give the same bytes;
* a checkpoint written from (2, 1) restores onto (1, 2) and onto one
  device, and one written on one device onto (2, 1), each rank holding
  its block of the written state bitwise; a resume from step 2 on (2, 1)
  ends bitwise where the uninterrupted run does.

Every spawn has its own process-group timeout and join timeout.
"""
import functools
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, token_split
from repro_torch.core import tree
from repro_torch.launch.mesh import spawn
from repro_torch.sharding import NULL_CTX

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
MESHES = [(1, 2), (2, 1), (2, 2)]
SPAWN_TIMEOUT_S = 180.0
REF_TIMEOUT_S = 600.0
# case -> (arch, fields of its reduced config replaced)
ARCHS = {
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
    "yi-6b": ("yi-6b", {}),
    "mamba2-130m": ("mamba2-130m", {}),
    "yi-6b-h6-kv3": ("yi-6b", dict(n_heads=6, kv_heads=3, head_dim=16)),
    "hymba-1.5b": ("hymba-1.5b", {}),
    "whisper-medium": ("whisper-medium", {}),
    "paligemma-3b": ("paligemma-3b", {}),
}
MOE_CAPACITY_FACTOR = 0.5
B, SEQ, STEPS = 4, 32, 3
ACCUM_ARCH, ACCUM_MESH = "granite-moe-1b-a400m", (2, 2)
# archs whose gradient norms after the first step move by more than 2e-3
# under the rounding the steps before them leave: from parameters changed
# by a random 1e-6 of each, the reference's own f32 steps give
# paligemma-3b norms of 24.30-24.64 and 17.38-18.09 at steps 1 and 2
# (granite-moe: dropped tokens)
FIRST_NORM_ONLY = ("granite-moe-1b-a400m", "paligemma-3b")
# whisper-medium moves further: under that change its first norm is
# 19.619-19.696 (19.654 unchanged; held within TOL of the norm), its
# norms at steps 1 and 2 11.75-11.88 and 12.02-14.60, and its mu after
# three steps moves by up to 7.7e-3. It takes one step, after which a
# leaf is off by less than 2 lr whatever its gradient's rounding
# (`tests/test_torch_mesh_placed_train.py` holds its gradients)
NORM_REL = ("whisper-medium",)
STEPS_OF = {"whisper-medium": 1}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
PARTS = ("params", "mu", "nu")
DATA, MODEL = 0, 1
AXIS = {"data": DATA, "model": MODEL}


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(get, case):
    arch, over = ARCHS[case]
    cfg = get(arch).reduced().replace(**F32, **over)
    return cfg.replace(capacity_factor=MOE_CAPACITY_FACTOR) if cfg.moe else cfg


def _steps(case):
    return STEPS_OF.get(case, STEPS)


def _accums(arch, shape):
    return (1, 2) if (arch, tuple(shape)) == (ACCUM_ARCH, ACCUM_MESH) \
        else (1,)


def _batches(pipeline, cfg):
    """The steps' batches: Markov tokens over the text positions, and for
    an enc-dec arch its frame embeddings (a VLM its patch embeddings) over
    the front positions, drawn with numpy from the step."""
    front, text = token_split(cfg, SEQ)
    task = pipeline.MarkovTask(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=text, global_batch=B))
    out = []
    for i in range(STEPS):
        batch = task.batch_for_step(i)
        if front:
            batch["frames" if cfg.enc_dec else "patches"] = \
                np.random.RandomState(i).randn(
                    B, front, cfg.d_model).astype(np.float32)
        out.append(batch)
    return out


def _flatten(node, prefix):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: node}


def _unflatten(flat, prefix):
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _norm_spec(spec):
    """A partition spec as the port writes it: one-axis tuples as the axis,
    trailing Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, (tuple, list)) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def draw_params(path):
    """Every arch's whole parameters, drawn by the port from seed 0."""
    from repro_torch.models.params import initialize
    from repro_torch.models.lm import param_specs

    arrays = {}
    for arch in ARCHS:
        gen = torch.Generator()
        gen.manual_seed(0)
        params = initialize(param_specs(_cfg(get_config, arch)), gen, "cpu")
        arrays.update({k: v.numpy() for k, v in
                       _flatten(params, f"params/{arch}").items()})
    np.savez(path, **arrays)


# ------------------------------------------------------------- the reference


def run_reference(params_path, out_path):
    """The reference's placed `jit_train_step` on every mesh (four forced
    host devices), into one npz. Run as a script by the module's
    fixture."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from repro.configs import get_config as ref_get_config
    from repro.data import pipeline as ref_pipeline
    from repro.models import build_model
    from repro.optim import AdamWConfig, init_state
    from repro.runtime.steps import jit_train_step, state_shardings
    from repro.sharding import ShardingCtx as RefCtx

    assert len(jax.devices()) == 4, jax.devices()
    given = np.load(params_path)
    out = {}
    for arch in ARCHS:
        cfg = _cfg(ref_get_config, arch)
        params = _unflatten({k: given[k] for k in given.files},
                            f"params/{arch}")
        batches = [{k: jnp.asarray(v) for k, v in b.items()}
                   for b in _batches(ref_pipeline, cfg)[:_steps(arch)]]
        for shape in MESHES:
            mesh = JaxMesh(np.array(jax.devices()[:shape[0] * shape[1]])
                           .reshape(shape), ("data", "model"))
            model = build_model(cfg, RefCtx(mesh=mesh))
            for accum in _accums(arch, shape):
                key = f"{arch}/{_tag(shape)}/accum{accum}"
                step = jit_train_step(model, AdamWConfig(**OPT), accum=accum)
                # new arrays each time: the step donates the state
                state = jax.device_put(
                    init_state(jax.tree.map(jnp.asarray, params)),
                    state_shardings(model))
                for i, batch in enumerate(batches):
                    state, m = step(state, batch)
                    for name in ("loss", "lr", "grad_norm"):
                        out[f"{key}/step{i}/{name}"] = np.asarray(m[name])
                for part in PARTS:
                    out.update({k: np.asarray(v) for k, v in _flatten(
                        state[part], f"{key}/state/{part}").items()})
                    out.update({k: np.array(repr(_norm_spec(v.sharding.spec)))
                                for k, v in _flatten(
                                    state[part], f"{key}/spec/{part}").items()})
                out[f"{key}/spec/step"] = np.array(repr(_norm_spec(
                    state["step"].sharding.spec)))
    np.savez(out_path, **out)


# ------------------------------------------------------------------ the port


def _rank_steps(ctx, params_path):
    """Every arch's three placed steps on this rank: metrics, its blocks of
    the state after them, and the bytes it holds of each part."""
    from repro_torch.data import pipeline
    from repro_torch.models import build_model
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import steps

    repro_torch.reset()
    given = np.load(params_path)
    out = {"coordinate": np.array(ctx.mesh.coordinate)}
    for arch in ARCHS:
        cfg = _cfg(get_config, arch)
        model = build_model(cfg, ctx)
        whole = params_from_numpy(_unflatten(
            {k: given[k] for k in given.files}, f"params/{arch}"), cfg, "cpu")
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _batches(pipeline, cfg)[:_steps(arch)]]
        for accum in _accums(arch, ctx.mesh.shape):
            key = f"{arch}/accum{accum}"
            step = steps.jit_train_step(model, AdamWConfig(**OPT),
                                        accum=accum)
            state = init_state(model.place(whole))
            for part in PARTS:
                out[f"{key}/bytes/{part}"] = np.array(sum(
                    x.numel() * x.element_size()
                    for x in tree.leaves(state[part])))
            for i, batch in enumerate(batches):
                state, m = step(state, steps.local_batch(ctx, batch, accum))
                for name in ("loss", "lr", "grad_norm"):
                    out[f"{key}/step{i}/{name}"] = m[name].numpy().copy()
            for part in PARTS:
                out.update({k: v.numpy().copy() for k, v in _flatten(
                    state[part], f"{key}/state/{part}").items()})
    return out


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The drawn parameters, and the reference's subprocess on them,
    started before the module's first test so that it runs while the
    port does (the checkpoint test, then the placed steps)."""
    out = tmp_path_factory.mktemp("mesh_placement")
    params_path = str(out / "params.npz")
    draw_params(params_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--reference",
             params_path, str(out / "ref.npz")], env=env,
            stdout=subprocess.DEVNULL, stderr=err)
    yield out, params_path, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def runs(_reference_run):
    """(the reference's npz, mesh tag -> every rank's results in rank
    order): the port's three meshes spawned at once, then the reference
    awaited."""
    out, params_path, proc = _reference_run
    with ThreadPoolExecutor(len(MESHES)) as pool:
        futures = {_tag(shape): pool.submit(
            spawn, functools.partial(_rank_steps, params_path=params_path),
            shape, device="cpu", backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
            for shape in MESHES}
        port = {tag: f.result() for tag, f in futures.items()}
    try:
        code = proc.wait(timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert code == 0, (out / "stderr.txt").read_text()[-4000:]
    return np.load(out / "ref.npz"), port


@functools.lru_cache(maxsize=None)
def _specs(arch, shape):
    from repro_torch.models import build_model
    from repro_torch.runtime.steps import state_shardings
    from repro_torch.sharding import Mesh, ShardingCtx

    ctx = ShardingCtx(mesh=Mesh(("data", "model"), shape))
    return state_shardings(build_model(_cfg(get_config, arch), ctx))


def _spec_of(arch, shape, name):
    """The port's placed spec of a state leaf named ``.../<part>/<path>``;
    () for a metric."""
    parts = name.split("/")
    at = [i for i, p in enumerate(parts) if p in PARTS]
    if not at:
        return ()
    node = _specs(arch, tuple(shape))[parts[at[-1]]]
    for key in parts[at[-1] + 1:]:
        node = node[key]
    return node if isinstance(node, tuple) else ()


def _block(whole, coord, shape, spec):
    for dim, entry in enumerate(spec):
        if entry is not None:
            axis = AXIS[entry]
            n = whole.shape[dim] // shape[axis]
            whole = np.take(whole, range(coord[axis] * n,
                                         (coord[axis] + 1) * n), axis=dim)
    return whole


def _close(got, want, what, rel=False):
    """Within TOL; with `rel` within TOL of `want`'s largest entry."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    bound = TOL * float(np.max(np.abs(want))) if rel else TOL
    assert err <= bound, f"{what}: max abs err {err}, bound {bound}"


# ---------------------------------------------------------------- checkpoints


def _train_kw(cfg):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import AdamWConfig

    return dict(data_cfg=DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=B),
                opt=AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4),
                log_every=1, ckpt_every=2, seed=5)


def _restored_blocks(ctx, ckpt_dir, step):
    """This rank's blocks of the state restored from `ckpt_dir` at `step`,
    on numpy."""
    from repro_torch.checkpointing.checkpoint import restore
    from repro_torch.models import build_model
    from repro_torch.optim import init_state
    from repro_torch.runtime.steps import held_state_specs

    model = build_model(_cfg(get_config, ACCUM_ARCH), ctx)
    gen = torch.Generator()
    gen.manual_seed(1)
    template = init_state(model.place(
        build_model(model.cfg).init(gen, "cpu")))
    specs = held_state_specs(model, template) if ctx.mesh is not None \
        else None
    state = restore(ckpt_dir, template, step=step, ctx=ctx, specs=specs)
    return {"/".join(p): x.numpy().copy() for p, x in tree.paths(state)}


def _rank_resume(ctx, root):
    """(2, 1): four steps uninterrupted, then two and a resume to four."""
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import train

    model = build_model(_cfg(get_config, ACCUM_ARCH), ctx)
    kw = _train_kw(model.cfg)
    full = train(model, steps=4, ckpt_dir=os.path.join(root, "full"), **kw)
    half = train(model, steps=2, ckpt_dir=os.path.join(root, "half"), **kw)
    resumed = train(model, steps=4, ckpt_dir=os.path.join(root, "half"),
                    **kw)
    return {"coordinate": ctx.mesh.coordinate, "full": full.losses,
            "half": half.losses, "resumed": resumed.losses,
            "resumed_from": resumed.resumed_from}


def _rank_restore(ctx, ckpt_dir, step):
    return {"coordinate": ctx.mesh.coordinate,
            "state": _restored_blocks(ctx, ckpt_dir, step)}


def _whole_checkpoint(ckpt_dir, step):
    from repro_torch.checkpointing.checkpoint import restore
    from repro_torch.models import build_model
    from repro_torch.optim import init_state

    model = build_model(_cfg(get_config, ACCUM_ARCH))
    template = init_state(model.init(torch.Generator(), "cpu"))
    state = restore(ckpt_dir, template, step=step)
    return {"/".join(p): x.numpy() for p, x in tree.paths(state)}


def _spec_of_path(shape, path):
    part, *rest = path.split("/")
    if part == "step":
        return ()
    node = _specs(ACCUM_ARCH, tuple(shape))[part]
    for key in rest:
        node = node[key]
    return node


def _assert_blocks_of(ranks, whole, shape):
    for res in ranks:
        assert sorted(res["state"]) == sorted(whole)
        for path, x in res["state"].items():
            want = _block(whole[path], res["coordinate"], shape,
                          _spec_of_path(shape, path))
            assert x.shape == want.shape and np.array_equal(x, want), path


def test_checkpoints_move_between_meshes_and_one_device(tmp_path):
    from repro_torch.checkpointing.checkpoint import latest_step
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import train

    ranks = spawn(functools.partial(_rank_resume, root=str(tmp_path)),
                  (2, 1), device="cpu", backend="gloo",
                  timeout_s=SPAWN_TIMEOUT_S)
    for res in ranks:
        assert res["resumed_from"] == 2
        assert res["full"] == ranks[0]["full"]
        assert res["resumed"] == {2: res["full"][2], 3: res["full"][3]}
        assert res["half"] == {0: res["full"][0], 1: res["full"][1]}
    assert latest_step(tmp_path / "full") == latest_step(tmp_path / "half") \
        == 4
    full = np.load(tmp_path / "full" / "step_00000004" / "arrays.npz")
    half = np.load(tmp_path / "half" / "step_00000004" / "arrays.npz")
    assert sorted(full.files) == sorted(half.files)
    for name in full.files:
        assert np.array_equal(full[name], half[name]), name
    # the single-device layout, whatever mesh wrote it
    whole = _whole_checkpoint(tmp_path / "full", 2)
    cfg = _cfg(get_config, ACCUM_ARCH)
    for path, x in tree.paths(build_model(cfg).abstract_params()):
        for part in PARTS:
            assert whole["/".join((part,) + tuple(path))].shape == x.shape
    # (2, 1)'s step 2 onto (1, 2), each rank its blocks
    onto = spawn(functools.partial(_rank_restore,
                                   ckpt_dir=str(tmp_path / "full"), step=2),
                 (1, 2), device="cpu", backend="gloo",
                 timeout_s=SPAWN_TIMEOUT_S)
    _assert_blocks_of(onto, whole, (1, 2))
    # ... and onto one device, where training resumes from it
    one = tmp_path / "one"
    shutil.copytree(tmp_path / "full" / "step_00000002",
                    one / "step_00000002")
    assert {k: v.shape for k, v in _restored_blocks(NULL_CTX, one,
                                                      2).items()} == \
        {k: v.shape for k, v in whole.items()}
    rep = train(build_model(cfg), steps=3, ckpt_dir=str(one), device="cpu",
                **_train_kw(cfg))
    assert rep.resumed_from == 2 and np.isfinite(rep.losses[2])
    # one device's step 3 onto (2, 1)
    back = spawn(functools.partial(_rank_restore, ckpt_dir=str(one), step=3),
                 (2, 1), device="cpu", backend="gloo",
                 timeout_s=SPAWN_TIMEOUT_S)
    _assert_blocks_of(back, _whole_checkpoint(one, 3), (2, 1))


def _rank_buckets(ctx):
    """The placement's collectives on reduced granite, whole groups and
    in buckets of 1000 elements: the gathered parameters and the reduced
    gradients (shares drawn from a seed of the rank), and the calls."""
    from repro_torch import sharding
    from repro_torch.models import build_model
    from repro_torch.runtime import steps

    cfg = _cfg(get_config, ACCUM_ARCH)
    model = build_model(cfg, ctx)
    gen = torch.Generator()
    gen.manual_seed(3)
    placed = model.place(build_model(cfg).init(gen, "cpu"))
    rank = 2 * ctx.mesh.coordinate[0] + ctx.mesh.coordinate[1]
    out = {}
    for cap in (sharding.BUCKET_ELEMS, 1000):
        sharding.BUCKET_ELEMS = cap
        sharding.reset_collective_stats()
        gathered = steps.gather_params(model, placed)
        shares = tree.map_tree(lambda x: torch.randn(
            x.shape, generator=torch.Generator().manual_seed(
                x.numel() + rank)), gathered)
        reduced = steps.reduce_grads(shares, model.held_param_specs(), ctx,
                                     model.param_partition_specs())
        out[cap] = {"gathered": tree.leaves(gathered),
                    "reduced": tree.leaves(reduced),
                    "calls": sharding.collective_stats()["calls"]}
    return out


def test_buckets_cut_the_collectives_and_change_no_byte():
    """At 1000 elements a bucket, the gathers and reductions of reduced
    granite on (2, 2) take more collectives and give the same bytes."""
    from repro_torch.sharding import BUCKET_ELEMS

    for res in spawn(_rank_buckets, (2, 2), device="cpu", backend="gloo",
                     timeout_s=SPAWN_TIMEOUT_S):
        whole, cut = res[BUCKET_ELEMS], res[1000]
        assert cut["calls"] > whole["calls"]
        for part in ("gathered", "reduced"):
            for a, b in zip(whole[part], cut[part]):
                assert torch.equal(a, b)


CASES = [(arch, shape, accum) for arch in ARCHS for shape in MESHES
         for accum in _accums(arch, shape)]


def _ids(case):
    return f"{case[0]}-{_tag(case[1])}-accum{case[2]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_placed_steps_match_the_reference_placed_step(runs, case):
    """Each step's loss and learning rate, its gradient norm (the first
    only of granite and paligemma, `FIRST_NORM_ONLY`: a later norm moves
    by more than 2e-3 under the rounding the steps before it leave;
    `test_torch_mesh_train` holds each of granite's later steps from the
    reference's own state; whisper's within 2e-3 of the norm, after its
    one step, `STEPS_OF`), and each rank's block of params, mu and nu
    after the steps."""
    ref, port = runs
    arch, shape, accum = case
    key = f"{arch}/accum{accum}"
    rkey = f"{arch}/{_tag(shape)}/accum{accum}"
    for r, res in enumerate(port[_tag(shape)]):
        coord = tuple(res["coordinate"])
        for i in range(_steps(arch)):
            norm = ("grad_norm",) if i == 0 or arch not in \
                FIRST_NORM_ONLY else ()
            for name in ("loss", "lr") + norm:
                _close(res[f"{key}/step{i}/{name}"],
                       ref[f"{rkey}/step{i}/{name}"],
                       f"rank {r} step {i} {name}",
                       rel=name == "grad_norm" and arch in NORM_REL)
        names = [k for k in ref.files if k.startswith(f"{rkey}/state/")]
        assert names
        for name in names:
            leaf = name[len(rkey) + 1:]
            _close(res[f"{key}/{leaf}"],
                   _block(ref[name], coord, shape,
                          _spec_of(arch, shape, leaf)), f"rank {r} {leaf}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_reference_output_specs_are_the_ports_state_shardings(runs, case):
    ref, _ = runs
    arch, shape, accum = case
    rkey = f"{arch}/{_tag(shape)}/accum{accum}"
    specs = _specs(arch, tuple(shape))
    assert str(ref[f"{rkey}/spec/step"]) == repr(specs["step"]) == "()"
    for part in PARTS:
        want = _flatten(specs[part], part)
        got = {k[len(rkey) + len("/spec/"):]: str(ref[k]) for k in ref.files
               if k.startswith(f"{rkey}/spec/{part}/")}
        assert sorted(got) == sorted(want)
        for name, spec in want.items():
            assert got[name] == repr(spec), name


def _share_bytes(cfg, shape):
    """Bytes of one part (params, mu or nu) a rank holds by the specs:
    each leaf's elements over the ranks its spec splits it over."""
    from repro_torch.models import build_model
    from repro_torch.sharding import Mesh, ShardingCtx, block_shape

    ctx = ShardingCtx(mesh=Mesh(("data", "model"), shape))
    model = build_model(cfg, ctx)
    leaves = tree.leaves(model.abstract_params())
    specs = tree.leaves(model.param_partition_specs())
    held = sum(int(np.prod(block_shape(x.shape, s, ctx))) * x.element_size()
               for x, s in zip(leaves, specs))
    return held, sum(x.numel() * x.element_size() for x in leaves)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_a_rank_holds_exactly_the_specs_share(runs, arch, shape):
    _, port = runs
    held, whole = _share_bytes(_cfg(get_config, arch), shape)
    assert held < whole
    for res in port[_tag(shape)]:
        for accum in _accums(arch, shape):
            for part in PARTS:
                assert int(res[f"{arch}/accum{accum}/bytes/{part}"]) == held


@pytest.mark.parametrize("arch,shape,held_gb,whole_gb", [
    ("granite-moe-1b-a400m", (2, 1), 2.669, 5.339),
    ("granite-moe-1b-a400m", (1, 2), 2.770, 5.339),
    ("granite-moe-1b-a400m", (2, 2), 1.385, 5.339),
    ("mamba2-130m", (2, 1), 0.258, 0.516),
    ("yi-6b", (2, 2), 6.061, 24.244),
])
def test_full_width_shares_by_the_specs(arch, shape, held_gb, whole_gb):
    """A rank's bytes of f32 params at full width, from the specs alone
    (meta tensors): about half the whole at a mesh of two."""
    cfg = get_config(arch).replace(**F32)
    held, whole = _share_bytes(cfg, shape)
    assert round(held / 1e9, 3) == held_gb
    assert round(whole / 1e9, 3) == whole_gb


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_replicated_blocks_are_bitwise_equal(runs, case):
    """Every block of the state after the steps, and every metric, is the
    same bytes on the ranks whose coordinates agree on the axes its
    placed spec splits it over."""
    _, port = runs
    arch, shape, accum = case
    ranks = port[_tag(shape)]
    names = [k for k in ranks[0] if k.startswith(f"{arch}/accum{accum}/")]
    assert names
    for name in names:
        split = [AXIS[e] for e in _spec_of(arch, shape, name) if e]
        for res in ranks:
            for other in ranks:
                if all(res["coordinate"][a] == other["coordinate"][a]
                       for a in split):
                    assert np.array_equal(res[name], other[name]), name


if __name__ == "__main__":
    if sys.argv[1:2] != ["--reference"] or len(sys.argv) != 4:
        sys.exit("usage: test_torch_mesh_placement.py --reference "
                 "PARAMS.npz OUT.npz")
    run_reference(sys.argv[2], sys.argv[3])
