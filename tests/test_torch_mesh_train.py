"""The port's training on a device mesh against the reference's.

The reference runs once for the module in a subprocess with four forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``):
this file run as a script (``--reference OUT.npz``) builds its meshes
(1, 2), (2, 1) and (2, 2) and, for each reduced f32 model (granite-moe with
a capacity factor that drops tokens, yi-6b, mamba2-130m), takes
``jax.value_and_grad`` of its mesh loss on the first Markov batch (4 x 32)
and three AdamW steps of its `make_train_step` (clip on, lr 1e-3), and for
granite-moe on (2, 2) the same three steps at ``accum=2``; its train
loop's compressed step (`ef_compress` of the global gradients, then
`apply_updates`) for three steps of granite-moe on (1, 2), and
`ef_compress` alone of that mesh's first gradients; then `compressed_psum`
in a `shard_map` over each axis of the (2, 2) mesh. Its mesh loss is not
its single-device loss for a MoE arch: each shard sizes its capacity from
its own tokens, drops by it, and the aux loss is the mean of the shards'.
The port runs each mesh as gloo ranks on the CPU (`launch.mesh.spawn`),
from the reference's parameters (`params_from_numpy`; the gradients at
the layout the model computes with, each train state placed by its rules,
`Model.place`) and its rows of each batch (`runtime.steps.local_batch`),
and the tests hold each rank's results against the reference's, in f32
within 2e-3:

* the loss, its cross-entropy and aux parts, and `global_norm` of the
  gradients; every gradient leaf, each rank's share of it; the aux term and
  each gradient leaf also within 2e-3 of its largest entry;
* the metrics of three `jit_train_step` steps (eager on a mesh) and the
  state after them, and at ``accum=2`` for granite-moe on (2, 2); and each
  step again from the state the reference's step started from;
* the blocks of the state that the placed specs replicate over an axis
  are bitwise equal across it after the steps, and so are the metrics;
* `ef_compress` of each rank's placed blocks equals the reference's of
  the whole leaves bitwise (each leaf quantized with its whole max), and
  three compressed steps match the reference's compressed step (the error
  state up to rounding flips of one quantization step);
* `moe_ep_a2a` (tokens dropped) and `moe_ep_replicated` alone: the
  gradients of sum(y * c) + aux in the router, the experts and the input;
* `compressed_psum` to f32 rounding (1e-6 of the sum's largest entry), and
  exactly n times one block through int8 where the n ranks hold the same.

Then, on (1, 2): `train` checkpoints the whole state in the single-device
layout, and a resume from step 2 ends bitwise where the uninterrupted run
does. Every spawn has its own process-group timeout and join timeout.
"""
import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.launch.mesh import spawn

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-3
F32 = dict(dtype="float32", param_dtype="float32")
MESHES = [(1, 2), (2, 1), (2, 2)]
SPAWN_TIMEOUT_S = 180.0
REF_TIMEOUT_S = 600.0
ARCHS = ["granite-moe-1b-a400m", "yi-6b", "mamba2-130m"]
MOE_CAPACITY_FACTOR = 0.5
B, SEQ, STEPS = 4, 32, 3
ACCUM_ARCH, ACCUM_MESH = "granite-moe-1b-a400m", "2x2"
COMPRESS_MESH = (1, 2)            # the compressed step's mesh
# as tests/test_torch_train_optim.py: AdamW's first steps move a parameter
# by about lr whatever its gradient's size, so lr 1e-3 keeps a near-zero
# gradient that rounds differently inside the tolerance; the clip (1.0)
# is on
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
PSUM_SHAPE = (2, 2, 8, 16)       # a block a rank of the (2, 2) mesh
PSUM_RTOL = 1e-6                 # f32 rounding, of the sum's largest entry
DATA, MODEL = 0, 1


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


def _cfg(get, arch):
    cfg = get(arch).reduced().replace(**F32)
    return cfg.replace(capacity_factor=MOE_CAPACITY_FACTOR) if cfg.moe else cfg


def _batches(pipeline, cfg):
    task = pipeline.MarkovTask(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=B))
    return [task.batch_for_step(i) for i in range(STEPS)]


def _accums(arch, tag):
    """The microbatch counts of the three steps: 2 as well for granite-moe
    on the (2, 2) mesh, whose microbatch is one row a data rank."""
    return (1, 2) if (arch, tag) == (ACCUM_ARCH, ACCUM_MESH) else (1,)


def _moe_inputs(cfg):
    """A MoE layer's weights, its input and the objective's weights
    (numpy, from a seed): the layer's objective is sum(y * c) + aux."""
    rng = np.random.default_rng(7)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    p = {"router": rng.normal(size=(d, e)) * 0.5,
         "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    x, c = rng.normal(size=(2, B, SEQ, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32), c.astype(np.float32))


# the expert-parallel backends: the sequence split (S 32) and the decode's
# replicated tokens (3 positions, which do not split over `model`)
MOE_BACKENDS = (("a2a", SEQ), ("replicated", 3))


def _psum_input():
    return np.random.default_rng(11).normal(size=PSUM_SHAPE).astype(
        np.float32)


def _flatten(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


# ------------------------------------------------------------- the reference


def run_reference(out_path):
    """The reference on every mesh (four forced host devices), into one
    npz. Run as a script by the `ref_path` fixture."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as ref_get_config
    from repro.data import pipeline as ref_pipeline
    from repro.launch.mesh import mesh_by_name
    from repro.models import build_model
    from repro.optim import AdamWConfig, init_state
    from repro.optim.adamw import global_norm
    from repro.optim.compression import compressed_psum
    from repro.runtime.steps import make_train_step
    from repro.sharding import ShardingCtx as RefCtx
    from repro.sharding import shard_map

    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    meshes = {_tag(s): JaxMesh(np.array(jax.devices()[:s[0] * s[1]])
                               .reshape(s), ("data", "model"))
              for s in MESHES[:2]}
    meshes["2x2"] = mesh_by_name("mini")
    for arch in ARCHS:
        cfg = _cfg(ref_get_config, arch)
        params = build_model(cfg).init(jax.random.PRNGKey(0))
        out.update(_flatten(params, f"params/{arch}"))
        batches = _batches(ref_pipeline, cfg)
        stacked = {k: jnp.asarray(np.stack([b[k] for b in batches]))
                   for k in batches[0]}
        for tag, mesh in meshes.items():
            model = build_model(cfg, RefCtx(mesh=mesh))
            key = f"{arch}/{tag}"
            for accum in _accums(arch, tag):
                step = make_train_step(model, AdamWConfig(**OPT), accum=accum)

                def run(params, stacked, step=step, model=model):
                    # one compilation: the gradients at the first batch and
                    # the steps as a scan (the jitted step called on its own
                    # output would compile again for the output's layout),
                    # which also gives the state each step starts from
                    def body(state, batch):
                        new, m = step(state, batch)
                        return new, (m, state)

                    vg = jax.value_and_grad(model.loss, has_aux=True)(
                        params, {k: v[0] for k, v in stacked.items()})
                    return vg, jax.lax.scan(body, init_state(params), stacked)

                ((total, metrics), grads), (state, (m, entering)) = \
                    jax.jit(run)(params, stacked)
                if accum == 1:
                    out[f"{key}/total"] = np.asarray(total)
                    out[f"{key}/ce"] = np.asarray(metrics["loss"])
                    out[f"{key}/aux"] = np.asarray(metrics["aux"])
                    out[f"{key}/grad_norm"] = np.asarray(global_norm(grads))
                    out.update(_flatten(grads, f"{key}/grads"))
                for i in range(STEPS):
                    for name in ("loss", "lr", "grad_norm"):
                        out[f"{key}/accum{accum}/step{i}/{name}"] = \
                            np.asarray(m[name][i])
                for part in ("params", "mu", "nu"):
                    out.update(_flatten(state[part],
                                        f"{key}/accum{accum}/state/{part}"))
                    for i in range(1, STEPS):
                        out.update(_flatten(
                            jax.tree.map(lambda x, i=i: x[i], entering[part]),
                            f"{key}/accum{accum}/entering{i}/{part}"))
        if arch == ACCUM_ARCH:
            # the same gradients on one device, which the mesh's differ from
            (_, _), grads = jax.jit(jax.value_and_grad(
                build_model(cfg).loss, has_aux=True))(
                    params, {k: v[0] for k, v in stacked.items()})
            out.update(_flatten(grads, f"{arch}/single/grads"))
    run_reference_compressed(out, meshes[_tag(COMPRESS_MESH)])
    from repro.models import moe as ref_moe

    cfg = _cfg(ref_get_config, ACCUM_ARCH)
    p, x, c = (jax.tree.map(jnp.asarray, a) for a in _moe_inputs(cfg))
    for tag, mesh in meshes.items():
        ctx = RefCtx(mesh=mesh)
        for backend, s in MOE_BACKENDS:
            layer = getattr(ref_moe, f"moe_ep_{backend}")

            def objective(p, x, layer=layer, ctx=ctx, s=s):
                y, aux = layer(p, x, cfg, ctx)
                return jnp.sum(y * c[:, :s]) + aux

            val, (gp, gx) = jax.jit(jax.value_and_grad(
                objective, argnums=(0, 1)))(p, x[:, :s])
            key = f"moe/{tag}/{backend}"
            out[f"{key}/value"] = np.asarray(val)
            out[f"{key}/grads/x"] = np.asarray(gx)
            out.update(_flatten(gp, f"{key}/grads"))
    x = jnp.asarray(_psum_input())
    for axis in ("data", "model"):
        fn = shard_map(functools.partial(compressed_psum, axis_name=axis),
                       mesh=meshes["2x2"], in_specs=P("data", "model"),
                       out_specs=P("data", "model"), check_vma=False)
        out[f"psum/{axis}"] = np.asarray(jax.jit(fn)(x))
    np.savez(out_path, **out)


def run_reference_compressed(out, mesh):
    """The reference train loop's compressed step (``train(...,
    compress_grads=True)``, `src/repro/runtime/train_loop.py` 45-58:
    `ef_compress` of the global gradients, then `apply_updates`) on
    `mesh`, three steps of granite-moe from its parameters; and
    `ef_compress` alone of that mesh's first gradients against an error
    state drawn from a seed."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.data import pipeline as ref_pipeline
    from repro.models import build_model
    from repro.optim import AdamWConfig, apply_updates, init_state
    from repro.optim.compression import ef_compress, init_error_state
    from repro.sharding import ShardingCtx as RefCtx

    cfg = _cfg(ref_get_config, ACCUM_ARCH)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    model = build_model(cfg, RefCtx(mesh=mesh))
    opt = AdamWConfig(**OPT)

    def step_fn(state, batch):
        err = state["grad_error"]
        state = {k: v for k, v in state.items() if k != "grad_error"}
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
            state["params"], batch)
        # observed, not used: each leaf's quantization step, the whole
        # leaf's max / 127 as `quantize_int8` takes it
        steps_ = jax.tree.map(lambda g, e: jnp.max(jnp.abs(
            g.astype(jnp.float32) + e)) / 127.0 + 1e-30, grads, err)
        grads, err = ef_compress(grads, err)
        new_state, om = apply_updates(state, grads, opt)
        new_state["grad_error"] = err
        return new_state, {"loss": loss, **om, "quant_step": steps_}

    batches = _batches(ref_pipeline, cfg)
    stacked = {k: jnp.asarray(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    state = init_state(params)
    state["grad_error"] = init_error_state(params)

    def body(state, batch):
        new, m = step_fn(state, batch)
        return new, (m, new["grad_error"])

    state, (m, errs) = jax.jit(lambda s, b: jax.lax.scan(body, s, b))(
        state, stacked)
    for i in range(STEPS):
        for name in ("loss", "lr", "grad_norm"):
            out[f"compress/step{i}/{name}"] = np.asarray(m[name][i])
    for part in ("params", "mu", "nu", "grad_error"):
        out.update(_flatten(state[part], f"compress/state/{part}"))
    out.update(_flatten(jax.tree.map(lambda e: e[0], errs),
                        "compress/step0/grad_error"))
    out.update(_flatten(jax.tree.map(lambda q: q[0], m["quant_step"]),
                        "compress/step0/quant_step"))
    grads = _unflatten_dict(out, f"{ACCUM_ARCH}/{_tag(COMPRESS_MESH)}/grads")
    err = _ef_error_input(grads)
    dq, new_err = ef_compress(jax.tree.map(jnp.asarray, grads),
                              jax.tree.map(jnp.asarray, err))
    out.update(_flatten(grads, "ef/grads"))
    out.update(_flatten(err, "ef/err_in"))
    out.update(_flatten(dq, "ef/dq"))
    out.update(_flatten(new_err, "ef/err"))


def _ef_error_input(grads):
    """An error state for `ef_compress` alone: each leaf a quarter of its
    gradient's largest entry times a standard normal draw (seed 13)."""
    rng = np.random.default_rng(13)

    def draw(g):
        return (rng.normal(size=g.shape) * 0.25
                * float(np.max(np.abs(g)))).astype(np.float32)

    return {k: draw(v) if not isinstance(v, dict) else _ef_error_input(v)
            for k, v in grads.items()} if isinstance(grads, dict) \
        else draw(grads)


def _unflatten_dict(flat, prefix):
    tree = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


# ------------------------------------------------------------------ the port


def _unflatten(npz, prefix):
    return _unflatten_dict({k: npz[k] for k in npz.files
                            if k.startswith(prefix + "/")}, prefix)


def _numpy(tree, prefix):
    return {k: v.detach().numpy().copy()
            for k, v in _flatten_torch(tree, prefix).items()}


def _flatten_torch(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_torch(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _rank_train(ctx, ref_path):
    """Everything one rank of a mesh computes: its share of every result
    (numpy), keyed as the reference's npz less the mesh's tag."""
    from repro_torch.data import pipeline
    from repro_torch.models import build_model
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.compression import (compressed_psum,
                                               ef_compress, init_error_state)
    from repro_torch.runtime import steps
    from repro_torch.sharding import local_shard

    repro_torch.reset()
    ref = np.load(ref_path)
    out = {"coordinate": np.array(ctx.mesh.coordinate)}
    for arch in ARCHS:
        cfg = _cfg(get_config, arch)
        model = build_model(cfg, ctx)
        specs = model.held_param_specs()
        whole = _unflatten(ref, f"params/{arch}")
        params = params_from_numpy(whole, cfg, "cpu", ctx)
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in _batches(pipeline, cfg)]
        b0 = steps.local_batch(ctx, batches[0])
        with torch.no_grad():
            total, metrics = model.loss(params, b0)
        loss, grads = steps.value_and_grad(model, params, b0)
        assert torch.equal(loss, total)
        grads = steps.reduce_grads(grads, specs, ctx)
        out[f"{arch}/total"] = ctx.mean_all(total).numpy()
        out[f"{arch}/ce"] = ctx.mean_all(metrics["loss"]).numpy()
        out[f"{arch}/aux"] = metrics["aux"].numpy()
        out[f"{arch}/grad_norm"] = global_norm(grads, ctx, specs).numpy()
        out.update(_numpy(grads, f"{arch}/grads"))
        for accum in _accums(arch, _tag(ctx.mesh.shape)):
            step = steps.jit_train_step(model, AdamWConfig(**OPT),
                                        accum=accum)
            assert step.graph is None
            state = init_state(model.place(params_from_numpy(whole, cfg,
                                                             "cpu")))
            for i, batch in enumerate(batches):
                state, m = step(state, steps.local_batch(ctx, batch, accum))
                for name in ("loss", "lr", "grad_norm"):
                    out[f"{arch}/accum{accum}/step{i}/{name}"] = \
                        m[name].numpy()
            for part in ("params", "mu", "nu"):
                out.update(_numpy(state[part],
                                  f"{arch}/accum{accum}/state/{part}"))
            # each step from the state the reference's step started from
            for i in range(1, STEPS):
                prefix = f"{arch}/{_tag(ctx.mesh.shape)}/accum{accum}"
                state = {part: model.place(params_from_numpy(
                    _unflatten(ref, f"{prefix}/entering{i}/{part}"), cfg,
                    "cpu")) for part in ("params", "mu", "nu")}
                state["step"] = torch.tensor(i, dtype=torch.int32)
                state, m = step(state, steps.local_batch(ctx, batches[i],
                                                         accum))
                for name in ("loss", "lr", "grad_norm"):
                    out[f"{arch}/accum{accum}/forced{i}/{name}"] = \
                        m[name].numpy()
                after = "state" if i == STEPS - 1 else f"entering{i + 1}"
                for part in ("params", "mu", "nu"):
                    out.update(_numpy(
                        state[part], f"{arch}/accum{accum}/forced{i}/"
                        f"{after}/{part}"))
    cfg = _cfg(get_config, ACCUM_ARCH)
    model = build_model(cfg, ctx)
    placed = model.param_partition_specs()
    blocks = {part: model.place(params_from_numpy(
        _unflatten(ref, f"ef/{part}"), cfg, "cpu"))
        for part in ("grads", "err_in")}
    dq, err = ef_compress(blocks["grads"], blocks["err_in"], ctx, placed)
    out.update(_numpy(dq, "ef/dq"))
    out.update(_numpy(err, "ef/err"))
    if tuple(ctx.mesh.shape) == COMPRESS_MESH:
        state = init_state(model.place(params_from_numpy(
            _unflatten(ref, f"params/{ACCUM_ARCH}"), cfg, "cpu")))
        state["grad_error"] = init_error_state(state["params"])
        step = steps.jit_train_step(model, AdamWConfig(**OPT), compress=True)
        for i, batch in enumerate(_batches(pipeline, cfg)):
            state, m = step(state, steps.local_batch(ctx, {
                k: torch.from_numpy(v) for k, v in batch.items()}))
            for name in ("loss", "lr", "grad_norm"):
                out[f"compress/step{i}/{name}"] = m[name].numpy()
            if i == 0:
                out.update(_numpy(state["grad_error"],
                                  "compress/step0/grad_error"))
        for part in ("params", "mu", "nu"):
            out.update(_numpy(state[part], f"compress/state/{part}"))
    from repro_torch.models import moe

    p, x, c = _moe_inputs(cfg)
    bspec = ctx.spec(("batch",), (B,))
    n_model, n = ctx.axis_sizes["model"], ctx.mesh.size
    for backend, s in MOE_BACKENDS:
        held = {k: local_shard(torch.from_numpy(v), moe.EXPERT_SPECS[k],
                               ctx).clone().requires_grad_()
                for k, v in p.items()}
        xs = local_shard(torch.from_numpy(x[:, :s]), bspec,
                         ctx).clone().requires_grad_()
        cs = local_shard(torch.from_numpy(c[:, :s]), bspec, ctx)
        y, aux = getattr(moe, f"moe_ep_{backend}")(held, xs, cfg, ctx)
        # this rank's share of the objective: its rows' sum, which every
        # `model` rank computes alike, and the aux term every rank holds
        share = (y * cs).sum() / n_model + aux / n
        grads = torch.autograd.grad(share, [*held.values(), xs])
        key = f"moe/{backend}"
        out[f"{key}/value"] = ctx.sum_over(share.detach(), ("data", "model"))
        for (name, spec), g in zip(moe.EXPERT_SPECS.items(), grads):
            axes = ("data",) if spec else ("data", "model")
            out[f"{key}/grads/{name}"] = ctx.sum_over(g, axes).numpy()
        out[f"{key}/grads/x"] = ctx.sum_over(grads[-1], ("model",)).numpy()
        out[f"{key}/value"] = out[f"{key}/value"].numpy()
    x = local_shard(torch.from_numpy(_psum_input()), ("data", "model"), ctx)
    same = torch.from_numpy(_psum_input()[:1, :1])
    for axis in ("data", "model"):
        out[f"psum/{axis}"] = compressed_psum(x, ctx, axis).numpy()
        out[f"psum/same/{axis}"] = compressed_psum(same, ctx, axis).numpy()
    return out


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
    out = tmp_path_factory.mktemp("mesh_train_ref")
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
            spawn, functools.partial(_rank_train, ref_path=ref_path), shape,
            device="cpu", backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
            for shape in MESHES}
        return {tag: run.result() for tag, run in runs.items()}


# ------------------------------------- the loop and resume (the port alone)


def _rank_resume(ctx, ckpt_root):
    """Four steps uninterrupted, then two and a resume to four, each
    checkpointing under its own directory."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train_loop import train

    cfg = _cfg(get_config, ACCUM_ARCH)
    model = build_model(cfg, ctx)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=B)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    kw = dict(data_cfg=data, opt=opt, log_every=1, ckpt_every=2, seed=5)
    full = train(model, steps=4, ckpt_dir=os.path.join(ckpt_root, "full"),
                 **kw)
    half = train(model, steps=2, ckpt_dir=os.path.join(ckpt_root, "half"),
                 **kw)
    resumed = train(model, steps=4, ckpt_dir=os.path.join(ckpt_root, "half"),
                    **kw)
    return {"full": full.losses, "half": half.losses,
            "resumed": resumed.losses, "resumed_from": resumed.resumed_from}


def test_resume_on_the_mesh_equals_the_uninterrupted_run(tmp_path):
    from repro_torch.checkpointing.checkpoint import latest_step
    from repro_torch.models import build_model

    ranks = spawn(functools.partial(_rank_resume, ckpt_root=str(tmp_path)),
                  (1, 2), device="cpu", backend="gloo",
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
    # the single-device layout: the experts whole, leaves in the tree's
    # order of the state (its keys sorted: mu, nu, params, step)
    cfg = _cfg(get_config, ACCUM_ARCH)
    whole = [tuple(p.shape)
             for p in tree.leaves(build_model(cfg).abstract_params())]
    shapes = [full[f"leaf_{i}"].shape for i in range(len(full.files))]
    assert shapes == whole * 3 + [()]


def _rank_loop_matches_steps(ctx):
    """`train` on the mesh (two steps, accum 2) against `make_train_step`
    on the same rank's rows: the same losses, and the global loss on every
    rank."""
    from repro_torch.data.pipeline import DataConfig, MarkovTask
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import steps
    from repro_torch.runtime.train_loop import train

    cfg = _cfg(get_config, ACCUM_ARCH)
    model = build_model(cfg, ctx)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=B)
    opt = AdamWConfig(**OPT)
    rep = train(model, steps=2, data_cfg=data, opt=opt, accum=2, log_every=1,
                seed=3, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    state = init_state(model.place(build_model(cfg).init(gen, "cpu")))
    step = steps.make_train_step(model, opt, accum=2)
    task = MarkovTask(data)
    losses = {}
    for i in range(2):
        batch = {k: torch.from_numpy(v)
                 for k, v in task.batch_for_step(i).items()}
        state, m = step(state, steps.local_batch(ctx, batch, 2))
        losses[i] = float(m["loss"])
    return {"loop": rep.losses, "steps": losses}


def test_train_loop_on_the_mesh_is_the_functional_step():
    ranks = spawn(_rank_loop_matches_steps, (2, 2), device="cpu",
                  backend="gloo", timeout_s=SPAWN_TIMEOUT_S)
    for res in ranks:
        assert res["loop"] == res["steps"] == ranks[0]["loop"]


def _outlast(ctx, seconds):
    import time

    time.sleep(seconds)
    return ctx.mesh.coordinate


def test_a_run_without_a_deadline_outlasts_the_collective_timeout():
    """`launch.train --mesh` spawns with ``deadline=False``: `timeout_s`
    then bounds the collectives only, and a run longer than it ends
    normally (with the deadline, the same run raises TimeoutError)."""
    fn = functools.partial(_outlast, seconds=4.0)
    assert spawn(fn, (1, 2), device="cpu", backend="gloo", timeout_s=2.0,
                 deadline=False) == [(0, 0), (0, 1)]
    with pytest.raises(TimeoutError):
        spawn(fn, (1, 2), device="cpu", backend="gloo", timeout_s=2.0)


def test_a_mesh_of_shapes_alone_cannot_train():
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import jit_train_step, make_train_step
    from repro_torch.sharding import Mesh, ShardingCtx

    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 2)))
    model = build_model(_cfg(get_config, "yi-6b"), ctx)
    for make in (jit_train_step, make_train_step):
        with pytest.raises(RuntimeError, match="running mesh"):
            make(model, AdamWConfig())


# ------------------------------------------------- against the reference


def _expert_dim(name):
    """The experts' dim of a stacked MoE leaf held split over `model`, or
    None for a leaf every rank holds whole."""
    parts = name.split("/")
    if "moe" in parts and parts[-1] in ("w_gate", "w_up", "w_down"):
        return 1
    return None


def _block(whole, coord, shape, name):
    dim = _expert_dim(name)
    if dim is None or shape[MODEL] == 1:
        return whole
    n = whole.shape[dim] // shape[MODEL]
    return np.take(whole, range(coord[MODEL] * n, (coord[MODEL] + 1) * n),
                   axis=dim)


STATE_PARTS = ("params", "mu", "nu", "grad_error")


@functools.lru_cache(maxsize=None)
def _placed_specs(arch, shape):
    from repro_torch.models import build_model
    from repro_torch.sharding import Mesh, ShardingCtx

    ctx = ShardingCtx(mesh=Mesh(("data", "model"), shape))
    return build_model(_cfg(get_config, arch), ctx).param_partition_specs()


def _placed_spec(arch, shape, name):
    """The placed spec (the port's `state_shardings`) of a state leaf
    named ``.../<part>/<path>``; () for a metric."""
    parts = name.split("/")
    at = [i for i, part in enumerate(parts) if part in STATE_PARTS]
    if not at:
        return ()
    node = _placed_specs(arch, tuple(shape))
    for key in parts[at[-1] + 1:]:
        node = node[key]
    return node


def _placed_block(whole, coord, shape, name, arch):
    """A rank's block of a whole state leaf under its placed spec."""
    for dim, entry in enumerate(_placed_spec(arch, shape, name)):
        if entry is not None:
            axis = {"data": DATA, "model": MODEL}[entry]
            n = whole.shape[dim] // shape[axis]
            whole = np.take(whole, range(coord[axis] * n,
                                         (coord[axis] + 1) * n), axis=dim)
    return whole


def _close(got, want, what, rel=False):
    """Within TOL; with `rel` also within TOL of `want`'s largest entry
    (a gradient leaf, the aux term: their sizes vary by orders, and the
    mesh's arithmetic differs from one device's by a share of the leaf)."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= TOL, f"{what}: max abs err {err}"
    if rel:
        largest = float(np.max(np.abs(want))) if want.size else 0.0
        assert err <= TOL * largest, \
            f"{what}: max abs err {err}, largest entry {largest}"


def _leaf_keys(ref, prefix):
    keys = [k for k in ref.files if k.startswith(prefix + "/")]
    assert keys, prefix
    return keys


ARCH_MESH = [(arch, shape) for arch in ARCHS for shape in MESHES]


def _ids(case):
    return f"{case[0]}-{_tag(case[1])}"


@pytest.mark.parametrize("case", ARCH_MESH, ids=_ids)
def test_loss_aux_and_grad_norm_match_reference(ref, port, case):
    arch, shape = case
    tag = _tag(shape)
    for r, res in enumerate(port[tag]):
        for name in ("total", "ce", "aux", "grad_norm"):
            _close(res[f"{arch}/{name}"], ref[f"{arch}/{tag}/{name}"],
                   f"rank {r} {name}", rel=name == "aux")
        assert res[f"{arch}/grad_norm"] == port[tag][0][f"{arch}/grad_norm"]


@pytest.mark.parametrize("case", ARCH_MESH, ids=_ids)
def test_every_gradient_leaf_matches_reference(ref, port, case):
    arch, shape = case
    tag = _tag(shape)
    for name in _leaf_keys(ref, f"{arch}/{tag}/grads"):
        leaf = name[len(f"{arch}/{tag}/"):]
        for r, res in enumerate(port[tag]):
            coord = tuple(res["coordinate"])
            _close(res[f"{arch}/{leaf}"],
                   _block(ref[name], coord, shape, leaf), f"rank {r} {leaf}",
                   rel=True)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_the_relative_check_tells_the_mesh_from_one_device(ref, shape):
    """The reference's MoE gradients on a mesh are not its gradients on one
    device (each shard sizes its capacity from its own tokens and drops by
    it, and the aux term is the mean of the shards'): on every mesh some
    leaf of the one-device gradients is off the mesh's by far more than
    TOL of its largest entry, so the relative check of
    `test_every_gradient_leaf_matches_reference` fails a port that
    computes one device's arithmetic on the mesh."""
    tag = _tag(shape)
    worst = 0.0
    for name in _leaf_keys(ref, f"{ACCUM_ARCH}/{tag}/grads"):
        single = ref[name.replace(f"/{tag}/", "/single/")]
        worst = max(worst, float(np.max(np.abs(single - ref[name]))
                                 / np.max(np.abs(ref[name]))))
    assert worst > 10 * TOL, worst


ACCUM_CASES = [(arch, shape, accum) for arch, shape in ARCH_MESH
               for accum in _accums(arch, _tag(shape))]


@pytest.mark.parametrize("case", ACCUM_CASES,
                         ids=lambda c: f"{_ids(c)}-accum{c[2]}")
def test_three_adamw_steps_match_reference(ref, port, case):
    """Three steps from the same parameters: each step's loss and learning
    rate, the first step's gradient norm, and the state after the three.
    (Each later step's norm is held from the reference's own state, in
    `test_each_adamw_step_from_the_reference_state_matches`: with tokens
    dropped, the norm of granite-moe's third step at ``accum=2`` moves by
    about 0.1 of 15 under a random 1e-6 change of the parameters, the
    size of the rounding the steps before it leave.)"""
    arch, shape, accum = case
    tag = _tag(shape)
    key = f"{arch}/accum{accum}"
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        for i in range(STEPS):
            for name in ("loss", "lr") + (("grad_norm",) if i == 0 else ()):
                _close(res[f"{key}/step{i}/{name}"],
                       ref[f"{arch}/{tag}/accum{accum}/step{i}/{name}"],
                       f"rank {r} step {i} {name}")
        for name in _leaf_keys(ref, f"{arch}/{tag}/accum{accum}/state"):
            leaf = name[len(f"{arch}/{tag}/"):]
            _close(res[f"{arch}/{leaf}"],
                   _placed_block(ref[name], coord, shape, leaf, arch),
                   f"rank {r} {leaf}")


@pytest.mark.parametrize("case", ACCUM_CASES,
                         ids=lambda c: f"{_ids(c)}-accum{c[2]}")
def test_each_adamw_step_from_the_reference_state_matches(ref, port, case):
    """Steps 2 and 3, each from the state (params, mu, nu, step) that the
    reference's step started from, this rank's share of it: the loss,
    learning rate and gradient norm, and the state after the step."""
    arch, shape, accum = case
    tag = _tag(shape)
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        for i in range(1, STEPS):
            for name in ("loss", "lr", "grad_norm"):
                _close(res[f"{arch}/accum{accum}/forced{i}/{name}"],
                       ref[f"{arch}/{tag}/accum{accum}/step{i}/{name}"],
                       f"rank {r} step {i} {name}")
            after = "state" if i == STEPS - 1 else f"entering{i + 1}"
            for name in _leaf_keys(ref,
                                   f"{arch}/{tag}/accum{accum}/{after}"):
                leaf = name[len(f"{arch}/{tag}/accum{accum}/"):]
                _close(res[f"{arch}/accum{accum}/forced{i}/{leaf}"],
                       _placed_block(ref[name], coord, shape, leaf, arch),
                       f"rank {r} step {i} {leaf}")


@pytest.mark.parametrize("case", ACCUM_CASES,
                         ids=lambda c: f"{_ids(c)}-accum{c[2]}")
def test_whole_leaves_are_bitwise_equal_on_every_rank(port, case):
    """Every block a rank holds of the state after the steps, and every
    metric, is bitwise equal on the ranks that hold the same block: those
    whose coordinates agree on the mesh axes its placed spec splits it
    over (every rank for a metric or a leaf the spec leaves whole)."""
    arch, shape, accum = case
    ranks = port[_tag(shape)]
    prefix = f"{arch}/accum{accum}/"
    names = [k for k in ranks[0] if k.startswith(prefix)]
    assert names
    axes = {"data": DATA, "model": MODEL}
    for name in names:
        split = [axes[e] for e in _placed_spec(arch, shape, name) if e]
        for res in ranks:
            same = [other for other in ranks
                    if all(tuple(other["coordinate"])[a]
                           == tuple(res["coordinate"])[a] for a in split)]
            assert all(np.array_equal(res[name], other[name])
                       for other in same), name


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_the_experts_split_over_model(port, shape):
    """Each rank holds E / model experts of each MoE leaf and every other
    leaf whole."""
    cfg = _cfg(get_config, ACCUM_ARCH)
    for res in port[_tag(shape)]:
        got = res[f"{ACCUM_ARCH}/grads/layers/moe/w_gate"]
        assert got.shape[1] == cfg.n_experts // shape[MODEL]
        assert res[f"{ACCUM_ARCH}/grads/layers/moe/router"].shape[-1] == \
            cfg.n_experts


def test_moe_capacity_drops_tokens_on_every_mesh():
    """The capacity factor drops tokens: each shard of the first batch has
    more assignments to some expert than its capacity holds."""
    from repro_torch.data import pipeline
    from repro_torch.models import moe

    cfg = _cfg(get_config, ACCUM_ARCH)
    tokens = B * SEQ
    for shape in MESHES:
        shard = tokens // (shape[DATA] * shape[MODEL])
        assert moe._capacity(shard, cfg) < shard * cfg.top_k / cfg.n_experts
    assert _batches(pipeline, cfg)[0]["tokens"].shape == (B, SEQ)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_ef_compress_on_placed_blocks_quantizes_by_the_whole_leaf(ref, port,
                                                                shape):
    """`ef_compress` of each rank's placed blocks of the same gradients and
    error state equals the reference's `ef_compress` of the whole leaves,
    cut to the block, bitwise: every leaf is quantized with its whole max,
    not its block's (where the two differ, a block's values move by up to
    half a quantization step, about 4e-3 of the leaf's largest entry)."""
    tag = _tag(shape)
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        for part in ("dq", "err"):
            for name in _leaf_keys(ref, f"ef/{part}"):
                leaf = "params/" + name[len(f"ef/{part}/"):]
                want = _placed_block(ref[name], coord, shape, leaf,
                                     ACCUM_ARCH)
                got = res[name]
                assert got.shape == want.shape, name
                assert np.array_equal(got, want), (
                    f"rank {r} {name}: max abs err "
                    f"{float(np.max(np.abs(got - want)))} of "
                    f"{float(np.max(np.abs(want)))}")


def test_compressed_step_on_the_mesh_matches_reference(ref, port):
    """Three compressed steps (`jit_train_step(compress=True)`, the error
    state placed with the parameters) on the (1, 2) mesh against the
    reference train loop's compressed step, which quantizes the whole
    gradients: each step's loss and learning rate, the first step's
    gradient norm, and each rank's block of params, mu and nu after the
    steps, within 2e-3; and its block of the error state after the first
    step (from the same parameters), within 2e-3 but for rounding flips.

    The error is the gradient's distance to its int8 grid: where the
    port's and the reference's g + e, equal but for f32 rounding, lie on
    two sides of a rounding boundary, the two errors differ by one
    quantization step of the leaf (7.8e-3 for the embedding here). Such an
    element must differ by that step within 2e-3, and at most 1% of a
    leaf's elements may flip; a scale that is not the whole leaf's moves
    every element of a block by its own amount. Later steps' norms and
    errors follow the gradients, which move by more than 2e-3 under the
    rounding the steps before them leave (tokens dropped, as in
    `test_three_adamw_steps_match_reference`)."""
    tag = _tag(COMPRESS_MESH)
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        for i in range(STEPS):
            for name in ("loss", "lr") + (("grad_norm",) if i == 0 else ()):
                _close(res[f"compress/step{i}/{name}"],
                       ref[f"compress/step{i}/{name}"],
                       f"rank {r} step {i} {name}")
        for name in _leaf_keys(ref, "compress/state"):
            if "/grad_error/" not in name:
                _close(res[name], _placed_block(ref[name], coord,
                                                COMPRESS_MESH, name,
                                                ACCUM_ARCH),
                       f"rank {r} {name}")
        for name in _leaf_keys(ref, "compress/step0/grad_error"):
            step = float(ref[name.replace("/grad_error/", "/quant_step/")])
            want = _placed_block(ref[name], coord, COMPRESS_MESH, name,
                                 ACCUM_ARCH)
            diff = np.abs(res[name] - want)
            flips = diff > TOL
            assert np.all(np.abs(diff[flips] - step) <= TOL), (
                f"rank {r} {name}: max abs err {float(diff.max())}, not a "
                f"flip of one step {step}")
            assert flips.sum() <= 0.01 * diff.size, (
                f"rank {r} {name}: {int(flips.sum())} of {diff.size} flip")


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("backend", [b for b, _ in MOE_BACKENDS])
def test_moe_layer_gradients_match_reference(ref, port, shape, backend):
    """`moe_ep_a2a` (tokens dropped) and `moe_ep_replicated` differentiated
    through the collectives and K2's `autograd.Function`: the objective
    sum(y * c) + aux and its gradients in the router, each rank's experts
    and its rows of x, against `jax.value_and_grad` of the reference's
    shard_map on the same mesh."""
    tag = _tag(shape)
    key = f"moe/{tag}/{backend}"
    for r, res in enumerate(port[tag]):
        coord = tuple(res["coordinate"])
        _close(res[f"moe/{backend}/value"], ref[f"{key}/value"],
               f"rank {r} value")
        for name in ("router", "w_gate", "w_up", "w_down"):
            want = ref[f"{key}/grads/{name}"]
            if name != "router" and shape[MODEL] > 1:
                n = want.shape[0] // shape[MODEL]
                want = want[coord[MODEL] * n:(coord[MODEL] + 1) * n]
            _close(res[f"moe/{backend}/grads/{name}"], want,
                   f"rank {r} d {name}", rel=True)
        want = ref[f"{key}/grads/x"]
        rows = want.shape[0] // shape[DATA]
        _close(res[f"moe/{backend}/grads/x"],
               want[coord[DATA] * rows:(coord[DATA] + 1) * rows],
               f"rank {r} d x", rel=True)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_compressed_psum_matches_reference(ref, port, axis):
    """The reference's arithmetic (the same int8 values, their int32 sum,
    the largest scale) to f32 rounding: within 1e-6 of the sum's largest
    entry, far below one quantization step, so one int8 value off by one
    fails; and the same bytes on every rank of the axis."""
    want_all = ref[f"psum/{axis}"]
    ranks = port["2x2"]
    for r, res in enumerate(ranks):
        coord = tuple(res["coordinate"])
        want = want_all[coord[DATA]:coord[DATA] + 1,
                        coord[MODEL]:coord[MODEL] + 1]
        got = res[f"psum/{axis}"]
        assert got.shape == want.shape
        err = float(np.max(np.abs(got - want)))
        assert err <= PSUM_RTOL * float(np.max(np.abs(want))), (axis, err)
        for other in ranks:
            same_line = tuple(other["coordinate"])[MODEL if axis == "data"
                                                   else DATA] == \
                coord[MODEL if axis == "data" else DATA]
            if same_line:
                assert np.array_equal(got, other[f"psum/{axis}"])


@pytest.mark.parametrize("axis", ["data", "model"])
def test_compressed_psum_of_equal_blocks_is_their_count_times_one(port,
                                                                  axis):
    """Where every rank of the axis holds the same block (so the same
    scale), the sum is exactly the axis's ranks times the block through
    int8, and within half a quantization step a rank of their exact sum."""
    from repro_torch.optim.compression import dequantize_int8, quantize_int8

    x = torch.from_numpy(_psum_input()[:1, :1])
    once = dequantize_int8(*quantize_int8(x)).numpy()
    step = float(np.abs(x.numpy()).max()) / 127.0
    for res in port["2x2"]:
        got = res[f"psum/same/{axis}"]
        assert np.array_equal(got, (2 * torch.from_numpy(once)).numpy())
        assert float(np.max(np.abs(got - 2 * x.numpy()))) <= step


if __name__ == "__main__":
    if sys.argv[1:2] != ["--reference"] or len(sys.argv) != 3:
        sys.exit("usage: test_torch_mesh_train.py --reference OUT.npz")
    run_reference(sys.argv[2])
