"""The port's dry-run (`launch/dryrun.py`, `roofline.StepCounter`, the dry
mesh of `sharding.py`) against the reference's and against a running mesh.

The reference's dry-run runs once, in one subprocess with 8 forced host
devices (as ``tests/test_dryrun_mini.py`` runs it), for the two cells the
comparisons read: mamba2-130m train_4k and granite-moe-1b-a400m decode_32k
on the mini mesh (data 4, model 2). The port traces the same cells on meta
tensors. The dry mesh's collectives are held, call for call and byte for
byte, to a running gloo mesh on the CPU (`launch.mesh.spawn`) that runs
the same reduced f32 steps; the extrapolation in depth to the full-depth
trace; the remat of the layer stack to the trace's temp bytes and FLOPs.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.configs.shapes import (ShapeSuite, batch_specs,
                                        decode_batch_specs)
from repro_torch.core import tree
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model
from repro_torch.models import params as pm
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import (local_batch, make_decode_step,
                                       make_prefill_step, make_train_step,
                                       value_and_grad)
from repro_torch.sharding import Mesh, ShardingCtx, block_shape

ROOT = Path(__file__).resolve().parent.parent
REF_CELLS = (("mamba2-130m", "train_4k"), ("granite-moe-1b-a400m",
                                            "decode_32k"))
F32 = dict(dtype="float32", param_dtype="float32")
MESHES = ((1, 2), (2, 1), (2, 2))
ARCHS = ("yi-6b", "granite-moe-1b-a400m", "mamba2-130m")
KINDS = ("train", "prefill", "decode")


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


# ------------------------------------------------- against the reference


_REF_SCRIPT = """
import json, sys
from repro.launch import dryrun
out = sys.argv[1]
for arch, shape in json.loads(sys.argv[2]):
    dryrun.run_cell(arch, shape, "mini", out_dir=out, verbose=False)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records of `REF_CELLS` on its 8-device mini mesh."""
    out = tmp_path_factory.mktemp("reference_dryrun")
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="8", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(out),
                           json.dumps(REF_CELLS)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {(a, s): json.loads((out / f"{a}__{s}__mini.json").read_text())
            for a, s in REF_CELLS}


@pytest.fixture(scope="module")
def port():
    """The port's records of `REF_CELLS` on the same mini mesh."""
    old = os.environ.get("REPRO_DRYRUN_DEVICES")
    os.environ["REPRO_DRYRUN_DEVICES"] = "8"
    try:
        return {(a, s): dryrun.run_cell(a, s, "mini", verbose=False)
                for a, s in REF_CELLS}
    finally:
        if old is None:
            del os.environ["REPRO_DRYRUN_DEVICES"]
        else:
            os.environ["REPRO_DRYRUN_DEVICES"] = old


def test_mini_mesh_is_the_references(port):
    for rec in port.values():
        assert rec["status"] == "ok" and rec["chips"] == 8
        assert rec["counted_by"] == "traced"
        assert rec["depth_info"]["mode"] == "traced_full_depth"


def test_train_argument_bytes_equal_the_references(reference, port):
    """mamba2-130m train_4k: the placed state (params, mu, nu, step) and
    the rows of the batch that the step reads, byte for byte."""
    cell = ("mamba2-130m", "train_4k")
    assert port[cell]["layout"] == "placed"
    assert port[cell]["memory"]["argument_size_in_bytes"] == \
        reference[cell]["memory"]["argument_size_in_bytes"]


def _held_decode_trace(arch: str, shape_name: str, mesh):
    """The held layout's decode traced on rank 0 of the dry `mesh`: every
    parameter leaf whole but the experts (`held_param_specs`), the cache a
    rank's rows with the K/V caches split by sequence over `model` where
    the reference splits them (``kv_seq``), every other axis whole. What
    the dry-run traced for serving before it placed the serving steps.
    Returns (the trace, the model)."""
    cfg = get_config(arch).replace(scan_layers=False)
    suite = dryrun.SHAPES[shape_name]
    ctx = ShardingCtx(mesh=sharding.dry_mesh(mesh))
    model = build_model(cfg, ctx)
    params = pm.local_params(model.abstract_params(), cfg, ctx)

    def held(s):
        axes = tuple(a if a in ("batch", "kv_seq") else None for a in s.axes)
        return ctx.spec(axes, s.shape)

    whole = model.abstract_cache(suite)
    cache = tree.map_tree(
        lambda x, spec: sharding.local_shard(x, spec, ctx).clone()
        if spec else x, whole, pm.map_specs(held, model.cache_specs(suite)))
    cache["kv_len"] = {k: whole["layers"][k].shape[2]
                       for k in ("k", "cross_k") if k in whole["layers"]}
    batch = dryrun._rows(decode_batch_specs(cfg, suite), ctx)
    return dryrun.trace_step(make_decode_step(model),
                             (params, cache, batch)), model


def test_decode_argument_bytes_differ_by_the_held_layout(reference, port):
    """granite-moe decode_32k: the dry-run places the parameters by
    `partition_specs` and the cache by `cache_shardings`, as the reference
    does, so its argument bytes are the reference's exactly; the held
    layout's (every leaf whole but the experts, `held_param_specs`) exceed
    them by exactly its parameters' blocks less their placed blocks."""
    cell = ("granite-moe-1b-a400m", "decode_32k")
    assert port[cell]["layout"] == "placed"
    assert port[cell]["memory"]["argument_size_in_bytes"] == \
        reference[cell]["memory"]["argument_size_in_bytes"]
    held, model = _held_decode_trace(*cell, Mesh(("data", "model"), (4, 2)))
    ctx = model.ctx
    extra = 0
    for (path, s), spec_held, placed in zip(
            tree.paths(model.param_specs()),
            tree.leaves(model.held_param_specs()),
            tree.leaves(model.param_partition_specs())):
        isz = pm.torch_dtype(s.dtype).itemsize
        extra += (math.prod(block_shape(s.shape, spec_held, ctx))
                  - math.prod(block_shape(s.shape, placed, ctx))) * isz
    assert extra > 0
    assert held["memory"]["argument_size_in_bytes"] - extra == \
        reference[cell]["memory"]["argument_size_in_bytes"]


# The traced FLOPs a chip against XLA's ``hlo_flops_per_chip`` for the same
# cell (measured: port / reference = 1.385 for the train cell, 1.569 before
# the train step computed on the placed layout; 0.185 for the decode cell,
# 0.190 before the placed serving step). By category:
#   * what the port computes whole on every rank of `model` (2 here) where
#     the reference's GSPMD step splits it over `model`: mamba2's SSM
#     block, whose ``d_inner`` and ``conv_dim`` splits the placed step
#     gathers before the layer (they are not among `lm.PARALLEL_AXES`): up
#     to 2x its matmul FLOPs. The embedding, the logits and the loss are
#     vocab-parallel on both sides, and the placed decode step splits the
#     attention and MLP projections (tensor parallelism), as the reference
#     does;
#   * elementwise ops: the trace counts matmuls and the kernels' products
#     only, XLA counts every elementwise op too (norms, gates, softmax,
#     converts, and in decode the select over the whole cache that the
#     reference's ``cache_update="full"`` writes): the decode cell's
#     reference count is ~5x its matmuls, the train cell's ~1.3x;
#   * both count remat's recomputed forward.
FLOPS_RATIO = {"mamba2-130m": 1.385, "granite-moe-1b-a400m": 0.185}
FLOPS_TOL = 0.05       # relative, about the measured ratio


@pytest.mark.parametrize("cell", REF_CELLS, ids=lambda c: "-".join(c))
def test_traced_flops_against_reference(reference, port, cell):
    ratio = port[cell]["hlo_flops_per_chip"] / \
        reference[cell]["hlo_flops_per_chip"]
    assert abs(ratio / FLOPS_RATIO[cell[0]] - 1) < FLOPS_TOL, ratio
    # the analytic numerator is the reference's, exactly
    assert port[cell]["model_flops_total"] == \
        reference[cell]["model_flops_total"]


# ------------------------------------------- the dry mesh against gloo


def _suite(kind: str) -> ShapeSuite:
    return ShapeSuite(f"tiny_{kind}", 32, 4, kind)


def _cfg(arch: str):
    return get_config(arch).reduced().replace(**F32)


def _real_args(model, kind: str, ctx: ShardingCtx):
    """This rank's real inputs of the cell's step, cut from whole tensors
    drawn from one seed as the dry-run cuts its meta inputs."""
    cfg, suite = model.cfg, _suite(kind)
    g = torch.Generator().manual_seed(0)
    whole = pm.initialize(model.param_specs(), g, "cpu")
    rng = np.random.RandomState(1)

    def batch(specs):
        return {k: torch.from_numpy(rng.randint(
            0, cfg.vocab, v.shape).astype(np.int32)) for k, v in
            specs.items()}

    if kind == "train":
        state = {"step": torch.zeros((), dtype=torch.int32)}
        state["params"] = model.place(whole)
        state["mu"] = model.place(tree.map_tree(torch.zeros_like, whole))
        state["nu"] = model.place(tree.map_tree(torch.zeros_like, whole))
        return make_train_step(model, AdamWConfig()), \
            (state, local_batch(ctx, batch(batch_specs(cfg, suite))))
    params = model.place(whole)
    if kind == "prefill":
        return make_prefill_step(model), \
            (params, local_batch(ctx, batch(batch_specs(cfg, suite))))
    cache = model.place_cache(tree.map_tree(
        lambda m: torch.zeros(m.shape, dtype=m.dtype),
        model.abstract_cache(suite)))
    return make_decode_step(model), \
        (params, cache, local_batch(ctx, batch(decode_batch_specs(cfg,
                                                                  suite))))


def _collectives_rank(ctx: ShardingCtx):
    """Every (arch, kind) step once on this rank; each step's collectives
    by kind (calls and bytes)."""
    torch.set_num_threads(1)
    out = {}
    for arch in ARCHS:
        model = build_model(_cfg(arch), ctx)
        for kind in KINDS:
            fn, args = _real_args(model, kind, ctx)
            sharding.reset_collective_stats()
            fn(*args)
            out[(arch, kind)] = sharding.collective_stats()["by_kind"]
    return out


@pytest.fixture(scope="module")
def running():
    """Rank 0's counts on each mesh shape, all three spawned at once."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {shape: pool.submit(spawn, _collectives_rank, shape,
                                   device="cpu", backend="gloo",
                                   timeout_s=300)
                for shape in MESHES}
        return {shape: run.result()[0] for shape, run in runs.items()}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dry_mesh_counts_the_running_meshs_collectives(running, shape, arch,
                                                       kind):
    """The dry mesh's rank 0 counts the collectives of a running gloo
    mesh's rank 0 for the same step, by kind, in calls and in bytes."""
    model, fn, args, _ = dryrun._build_step(
        _cfg(arch), _suite(kind), Mesh(("data", "model"), shape))
    sharding.reset_collective_stats()
    fn(*args)
    dry = sharding.collective_stats()["by_kind"]
    assert dry == running[shape][(arch, kind)]
    if math.prod(shape) > 1 and kind == "train":
        assert dry                     # a train step on a mesh collects
    traced = dryrun.trace_step(fn, dryrun._build_step(
        _cfg(arch), _suite(kind), Mesh(("data", "model"), shape))[2])
    assert traced["collectives"] == {k: v["bytes"] for k, v in dry.items()}
    assert traced["collective_calls"] == {k: v["calls"]
                                          for k, v in dry.items()}


# ------------------------------------------------------------ extrapolation


@pytest.mark.parametrize("arch,shape,mesh", [
    ("mamba2-130m", "train_4k", "single"),
    ("granite-moe-1b-a400m", "decode_32k", "multi"),
    ("whisper-medium", "prefill_32k", "single")],
    ids=lambda v: str(v))
def test_depth_extrapolation_equals_the_full_trace(arch, shape, mesh):
    """Counts are linear in depth: the reference's `_extrapolate` of the
    depth-2 and depth-6 traces gives the full-depth trace's within 1e-9."""
    from repro_torch.configs.shapes import SHAPES

    cfg = get_config(arch).replace(scan_layers=False)
    suite, m = SHAPES[shape], dryrun._mesh(mesh)
    full = dryrun._trace(cfg, suite, m)
    d2, d6 = (dryrun._trace(dryrun._depth_override(cfg, n), suite, m)
              for n in dryrun.DEPTHS)
    est = dryrun._extrapolate(d2, d6, cfg.n_layers)
    for key in ("flops", "bytes", "hbm"):
        assert est[key] == pytest.approx(full[key], rel=1e-9), key
    assert set(est["collectives"]) == set(full["collectives"])
    for kind, nbytes in full["collectives"].items():
        assert est["collectives"][kind] == pytest.approx(nbytes, rel=1e-9)


# -------------------------------------------------------------------- remat


def _remat_cfg(arch: str, remat: bool, policy: str = "nothing"):
    return _cfg(arch).replace(remat=remat, remat_policy=policy)


def _train_batch(cfg, b=2, s=32):
    rng = np.random.RandomState(3)
    return {k: torch.from_numpy(rng.randint(0, cfg.vocab, (b, s))
                                .astype(np.int32))
            for k in ("tokens", "targets")}


@pytest.mark.parametrize("arch", ARCHS + ("hymba-1.5b",))
def test_remat_leaves_loss_and_gradients_bitwise(arch):
    """Remat on (policies "nothing" and "dots") and off: the same loss and
    every gradient leaf, bitwise on the CPU."""
    runs = []
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        cfg = _remat_cfg(arch, remat, policy)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        loss, grads = value_and_grad(model, params, _train_batch(cfg))
        runs.append((loss, tree.leaves(grads)))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads, runs[0][1]):
            assert torch.equal(a, b)


def _traced_grad(cfg):
    """The traced value_and_grad of a reduced train batch on meta
    parameters."""
    model = build_model(cfg)
    params = model.abstract_params()
    batch = {k: v.to("meta") for k, v in _train_batch(cfg).items()}
    return dryrun.trace_step(lambda p, b: value_and_grad(model, p, b),
                             (params, batch))


def _blocks_forward_flops(cfg) -> float:
    """The FLOPs of the layer stack's forward alone (no grad), on the
    embedded batch: what remat recomputes."""
    from repro_torch.models import lm

    model = build_model(cfg)
    params = model.abstract_params()
    x, positions = lm._embed_in(params, {k: v.to("meta") for k, v in
                                         _train_batch(cfg).items()}, cfg)
    with torch.no_grad():
        out = dryrun.trace_step(
            lambda layers, x: lm.run_layers_full(layers, x, cfg,
                                                 positions=positions),
            (params["layers"], x))
    return out["flops"]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_trades_temp_bytes_for_the_forwards_flops(arch):
    """With remat the traced step keeps less (temp bytes fall) and
    recomputes each layer's forward in the backward: its FLOPs rise by the
    layer stack's forward FLOPs, less what the recompute need not redo
    (it stops once the backward has what it needs, as XLA drops the dead
    tail of a rematerialized body: each layer's last product); policy
    "dots" keeps the matmuls (K2's products among them), so its FLOPs are
    remat-off's and K4's recomputed scans'."""
    off = _traced_grad(_remat_cfg(arch, False))
    on = _traced_grad(_remat_cfg(arch, True))
    dots = _traced_grad(_remat_cfg(arch, True, "dots"))
    assert on["memory"]["temp_size_in_bytes"] < \
        off["memory"]["temp_size_in_bytes"]
    forward = _blocks_forward_flops(_remat_cfg(arch, False))
    assert 0.5 * forward <= on["flops"] - off["flops"] <= forward
    def k4(run):
        return run["kernels"].get("ssd_scan", {}).get("flops", 0.0)

    assert dots["flops"] - off["flops"] == k4(dots) - k4(off)
    assert (k4(dots) > k4(off)) == (arch == "mamba2-130m")
    assert on["memory"]["argument_size_in_bytes"] == \
        off["memory"]["argument_size_in_bytes"]


# --------------------------------------------------------------- the sweep


def test_every_cell_of_a_mesh_is_ok_or_skipped_as_the_reference_says(
        tmp_path):
    """`main` over every arch and shape of the single mesh: each cell ok,
    or skipped where `cell_supported` refuses it; no error; exit 0."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cell_supported as ref_supported
    from repro.configs import get_config as ref_get_config

    dryrun.main(["--arch", "all", "--shape", "all", "--mesh", "single",
                 "--out", str(tmp_path), "--jobs", "4"])
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 40
    for r in recs:
        ok, _ = ref_supported(ref_get_config(r["arch"]),
                              REF_SHAPES[r["shape"]])
        assert r["status"] == ("ok" if ok else "skipped"), r
        if ok:
            assert r["machine"] == "h100"
            assert r["chips"] == 256
            assert r["dominant"] in ("compute_s", "memory_s",
                                     "collective_s")
            assert r["layout"] == "placed"


def test_yi_decode_useful_ratio_is_the_held_layouts():
    """yi-6b decode_32k on the single mesh: on the held layout every rank
    of the 16-way `model` axis repeats the dense projections over its
    rows, so its useful FLOPs ratio is near 1/7; the dry-run's placed
    step splits them over `model` (tensor parallelism), leaving whole only
    what the guard does (`wk`/`wv`: 4 K/V heads on 16 ranks), so its
    ratio is above 0.5."""
    from repro_torch import roofline

    rec = dryrun.run_cell("yi-6b", "decode_32k", "single", verbose=False)
    assert rec["layout"] == "placed"
    assert rec["useful_flops_ratio"] >= 0.5
    assert rec["collective_bytes"]          # the split cache's merge
    held, model = _held_decode_trace("yi-6b", "decode_32k",
                                     dryrun._mesh("single"))
    useful = roofline.model_flops(model.cfg, dryrun.SHAPES["decode_32k"],
                                  "decode") / rec["chips"]
    assert 0.13 < useful / held["flops"] < 0.15


@pytest.mark.parametrize("arch", ["granite-3-2b", "internlm2-20b",
                                  "command-r-plus-104b"])
def test_dense_decode_useful_ratio_on_the_placed_layout(arch):
    """The other dense archs' decode_32k on the single mesh: at least 0.5
    of the traced FLOPs are useful on the placed layout (the held
    layout's were 0.091-0.172), every record placed."""
    rec = dryrun.run_cell(arch, "decode_32k", "single", verbose=False)
    assert rec["layout"] == "placed"
    assert rec["useful_flops_ratio"] >= 0.5


def _held_train_trace(arch: str, shape_name: str, mesh):
    """The train step as the port ran it on a mesh before it computed on
    the placed layout, traced on rank 0 of the dry `mesh`: the placed
    parameters gathered once to the serving layout (`gather_params`:
    every leaf whole but the experts), differentiated there, the shares
    reduced into the placed blocks (`reduce_grads`), AdamW. Returns (the
    trace, the model)."""
    from repro_torch.optim import apply_updates
    from repro_torch.runtime.steps import gather_params, reduce_grads

    cfg = get_config(arch).replace(scan_layers=False)
    model, _, (state, batch), _ = dryrun._build_step(
        cfg, dryrun.SHAPES[shape_name], mesh)
    ctx, placed = model.ctx, model.param_partition_specs()

    def step(state, batch):
        held = gather_params(model, state["params"])
        loss, grads = value_and_grad(model, held, batch)
        del held
        grads = reduce_grads(grads, model.held_param_specs(), ctx, placed)
        new, metrics = apply_updates(state, grads, AdamWConfig(), ctx=ctx,
                                     specs=placed)
        return new, {"loss": ctx.mean_all(loss), **metrics}

    return dryrun.trace_step(step, (state, batch)), model


@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-2b", "internlm2-20b",
                                  "command-r-plus-104b"])
def test_dense_train_useful_ratio_on_the_placed_layout(arch):
    """The dense archs' train_4k on the single mesh: the train step
    computes on the placed layout (each layer gathered over `data` inside
    its remat, the projections tensor-parallel over `model`), so at least
    0.4 of its traced FLOPs are useful, where the held layout's step (the
    parameters gathered whole once a step) reached below 0.1 (0.045-0.079);
    and its temp bytes fall below the held layout's."""
    from repro_torch import roofline

    rec = dryrun.run_cell(arch, "train_4k", "single", verbose=False)
    assert rec["layout"] == "placed"
    assert rec["useful_flops_ratio"] >= 0.4
    held, model = _held_train_trace(arch, "train_4k", dryrun._mesh("single"))
    useful = roofline.model_flops(model.cfg, dryrun.SHAPES["train_4k"],
                                  "train") / rec["chips"]
    assert useful / held["flops"] < 0.1
    assert rec["memory"]["temp_size_in_bytes"] < \
        held["memory"]["temp_size_in_bytes"]


def test_whisper_train_ratio_above_one_is_the_formulas_count():
    """whisper-medium's train_4k on the single mesh reads a useful ratio
    above 1: `roofline.model_flops` (the reference's formula) counts every
    parameter of both stacks for every position, the 4096 frames and the
    1024 text tokens alike, 1.84x what each stack runs on its own
    positions (the encoder on the frames, the decoder on the text, its
    cross-attention's K/V on the frames, the unembedding on the text).
    Counted so, at least 0.4 and at most all of the traced FLOPs are
    useful, as on the dense archs."""
    from repro_torch import roofline
    from repro_torch.configs import token_split

    rec = dryrun.run_cell("whisper-medium", "train_4k", "single",
                          verbose=False)
    assert rec["layout"] == "placed" and rec["useful_flops_ratio"] > 1
    cfg, suite = get_config("whisper-medium"), dryrun.SHAPES["train_4k"]
    front, text = token_split(cfg, suite.seq_len)
    b, d, hd = suite.global_batch, cfg.d_model, cfg.resolved_head_dim
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.kv_heads * hd
    layer = attn + 3 * d * cfg.d_ff + 2 * d
    cross_kv = 2 * d * cfg.kv_heads * hd
    enc = cfg.n_enc_layers * layer
    dec = cfg.n_layers * (layer + attn + d - cross_kv)
    head = cfg.vocab * d                        # tied: the unembedding
    assert enc + dec + cfg.n_layers * cross_kv + head == \
        roofline._flops_params(cfg)
    mixer = rec["model_flops_total"] - 6.0 * roofline._flops_params(cfg) \
        * b * (front + text)
    per_stack = 6.0 * b * (enc * front + dec * text + cfg.n_layers
                           * cross_kv * front + head * text) + mixer
    assert rec["model_flops_total"] / per_stack > 1.8
    useful = per_stack / rec["chips"] / rec["hlo_flops_per_chip"]
    assert 0.4 <= useful <= 1.0, useful


def test_placed_argument_bytes_are_the_placed_leaves():
    """yi-6b prefill and decode on (1, 2): the argument bytes a chip are the
    placed parameters, plus the placed cache and the rows of the batch's
    tokens (the one input the steps read)."""
    shape = (1, 2)
    mesh = Mesh(("data", "model"), shape)
    ctx = ShardingCtx(mesh=mesh)
    cfg = get_config("yi-6b")
    model = build_model(cfg, ctx)
    params = sum(math.prod(block_shape(s.shape, spec, ctx))
                 * pm.torch_dtype(s.dtype).itemsize
                 for s, spec in zip(tree.leaves(model.param_specs()),
                                    tree.leaves(model.param_shardings())))
    assert params == 12_122_603_520
    for kind in ("prefill", "decode"):
        suite = dryrun.SHAPES[f"{kind}_32k"]
        _, fn, args, layout = dryrun._build_step(cfg, suite, mesh)
        assert layout == "placed"
        rec = dryrun.trace_step(fn, args)
        tokens = args[-1]["tokens"]         # the rows the step reads
        want = params + tokens.numel() * tokens.element_size()
        if kind == "decode":
            whole = model.abstract_cache(suite)
            want += sum(math.prod(block_shape(x.shape, spec, ctx))
                        * x.element_size() for x, spec in zip(
                            tree.leaves(whole),
                            tree.leaves(model.cache_shardings(suite))))
        assert rec["memory"]["argument_size_in_bytes"] == want, kind


def test_main_records_an_error_and_exits_1(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("broken step")

    monkeypatch.setattr(dryrun, "_build_step", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--mesh",
                     "single", "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "yi-6b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "error" and "broken step" in rec["error"]


def test_dryrun_launches_nothing_and_counts_every_kernel_call():
    """A dry cell's step runs on meta tensors only: no kernel launches,
    every kernel call a meta call with its cost (granite-moe's train step
    under remat: K2 12 times a layer)."""
    from repro_torch.kernels import launch_counts

    rec = dryrun.run_cell("granite-moe-1b-a400m", "train_4k", "single",
                          verbose=False)
    assert not any(launch_counts().values())
    assert rec["kernels"]["moe_gmm"]["calls"] == 12 * 24
    assert rec["kernels"]["moe_gmm"]["flops"] > 0

