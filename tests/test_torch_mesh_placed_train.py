"""The train step on the placed layout, on gloo ranks on the CPU.

On a mesh the step differentiates each rank's placed blocks as they are:
each layer gathers its leaves inside its remat (and again in the
recompute), the dense projections run tensor-parallel over `model`, and
the gather's backward reduce-scatters each gradient into the rank's block
(`sharding.gather_blocks`, `models.lm.run_layers_full`,
`runtime.steps._loss_and_grads`). The tests hold:

* the gather's backward against `sharding.reduce_blocks` of the same
  cotangents, bitwise, on (1, 2), (2, 1) and (2, 2): f32 and bf16 leaves,
  gathered over `data`, over `model` or over both, whole groups and in
  buckets of 1000 elements; a leaf that some axis does not place summed
  over it after the backward; the gathered leaves equal to the no-grad
  gather's, and both paths' collectives by kind, calls and bytes as the
  specs count them (the no-grad path adds no backward);
* a mesh step of reduced f32 granite-moe, yi-6b, mamba2-130m, yi-6b
  with 6 heads over 3 K/V heads (`OVERRIDES`), hymba-1.5b (hybrid heads), whisper-medium (its encoder, and the
  decoder's cross-attention on frame embeddings) and paligemma-3b (a
  prefix of patch embeddings) that never calls `steps.gather_params`,
  whose gathered leaves alive at one time never exceed its largest
  layer's plus the top-level leaves', that gathers each layer twice (its
  forward and its recompute; the encoder's layers too), whose attention
  weights reach the layer split over `model`, and whose gradients are the
  placed blocks, within 2e-5 of the serving layout's gradients reduced
  into them;
* the vocab-parallel cross-entropy (`lm._xent_split`) against `_xent` on
  the whole logits within 2e-3 in f32, loss and gradient;
* AdamW in place on a mesh, in runs along each leaf's leading axis
  (`optim.adamw.UPDATE_RUN_BYTES`), bitwise the functional update.

The reference's placed step is held against this one by
`tests/test_torch_mesh_placement.py` and `tests/test_torch_mesh_train.py`.
"""
import functools
import math
import weakref

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.launch.mesh import spawn

MESHES = [(1, 2), (2, 1), (2, 2)]
SPAWN_TIMEOUT_S = 180.0
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ("granite-moe-1b-a400m", "yi-6b", "mamba2-130m", "yi-6b-h6-kv3",
         "hymba-1.5b", "whisper-medium", "paligemma-3b")
# yi-6b with 6 heads over 3 K/V heads: `model` 2 does not divide the K/V
# heads, so `wk`/`wv` stay whole and each rank's 3 q heads project the
# span of K/V heads they read (`lm._kv_weights`)
OVERRIDES = {"yi-6b-h6-kv3": ("yi-6b", dict(n_heads=6, kv_heads=3,
                                             head_dim=16))}
XENT_TOL = 2e-3
GRAD_TOL = 2e-5
# archs whose f32 gradients on the two layouts differ by more than
# GRAD_TOL from rounding alone, held within GRAD_RTOL of each leaf's
# largest entry where that is the larger bound: on (1, 2) the gap is up to 7e-5 of it for hymba-1.5b
# (its SSM scans in f32 whatever the dtype, as mamba2's does), 2e-4 for
# whisper-medium (5e-7 with the model in f64) and 2.4e-5 for
# paligemma-3b; a term left out or counted twice moves a leaf by a
# large share of it
ROUNDED = ("hymba-1.5b", "whisper-medium", "paligemma-3b")
GRAD_RTOL = 1e-3

# (shape, dtype, fine, coarse): every live axis of a mesh places each leaf
# but the last, so that `reduce_blocks` sums nothing past the scatter;
# the last is placed over `data` alone and summed over `model` after.
LEAVES = [
    ((16, 48), torch.float32, ("data", "model"), (None, "model")),
    ((32, 40), torch.bfloat16, (("data", "model"),), ()),
    ((8, 16, 12), torch.float32, (None, "model", "data"), ()),
    ((16, 24), torch.bfloat16, ("model", "data"), ("model",)),
    ((24, 32), torch.float32, ("data", "model"), (None, "model")),
    ((12, 80), torch.float32, (None, ("model", "data")), ()),
    ((16, 36), torch.float32, ("data",), ()),
]


def _tag(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


# ----------------------------------------------------- the gather's backward


def _draw(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def _buckets(members, cap):
    """`members` ((block, ranks gathered over) in turn) cut into runs of
    at most `cap` gathered elements (a larger one alone)."""
    runs, run = [], []
    for x, n in members:
        if run and sum(y.numel() * m for y, m in run) + x.numel() * n > cap:
            runs.append(run)
            run = []
        run.append((x, n))
    return runs + ([run] if run else [])


def _expected_counts(blocks, fine, coarse, ctx, cap):
    """The gathers' collectives as the specs count them: one all_gather a
    bucket of the leaves moved over the same axes in the same type (its
    bytes the bucket's blocks), and for the backward one all_to_all a
    bucket of the leaves moved over the same axes, of any type, as one
    f32 buffer of the gathered size."""
    from repro_torch.sharding import _moved_axes

    by_type, by_axes = {}, {}
    for x, f, c in zip(blocks, fine, coarse):
        axes = _moved_axes(f, c, ctx)
        if axes:
            n = math.prod(ctx.axis_sizes[a] for a in axes)
            by_type.setdefault((axes, x.dtype), []).append((x, n))
            by_axes.setdefault(axes, []).append((x, n))
    gather = {"calls": 0, "bytes": 0}
    for members in by_type.values():
        for run in _buckets(members, cap):
            gather["calls"] += 1
            gather["bytes"] += sum(y.numel() * y.element_size()
                                   for y, _ in run)
    scatter = {"calls": 0, "bytes": 0}
    for members in by_axes.values():
        for run in _buckets(members, cap):
            scatter["calls"] += 1
            scatter["bytes"] += sum(y.numel() * m for y, m in run) * 4
    return gather, scatter


def _rank_gather(ctx):
    """This rank's blocks of `LEAVES` gathered with and without grad, the
    gradient of cotangents drawn from a seed of the rank, and
    `reduce_blocks` of the same cotangents, whole groups and in buckets
    of 1000 elements; each path's collectives by kind."""
    from repro_torch import sharding

    torch.set_num_threads(1)
    rank = ctx.index("data") * ctx.axis_sizes["model"] + ctx.index("model")
    fine = [f for _, _, f, _ in LEAVES]
    coarse = [c for _, _, _, c in LEAVES]
    wholes = [_draw(s, dt, 7 + i) for i, (s, dt, _, _) in enumerate(LEAVES)]
    blocks = [sharding.local_shard(w, f, ctx).clone()
              for w, f in zip(wholes, fine)]
    out = {"wholes": wholes, "coordinate": tuple(ctx.mesh.coordinate)}
    for cap in (sharding.BUCKET_ELEMS, 1000):
        sharding.BUCKET_ELEMS = cap
        sharding.reset_collective_stats()
        with torch.no_grad():
            plain = sharding.gather_blocks(blocks, fine, coarse, ctx)
        no_grad = sharding.collective_stats()["by_kind"]
        leaves = [b.detach().requires_grad_(True) for b in blocks]
        sharding.reset_collective_stats()
        got = sharding.gather_blocks(leaves, fine, coarse, ctx)
        forward = sharding.collective_stats()["by_kind"]
        cots = [_draw(y.shape, y.dtype, 100 * rank + i)
                for i, y in enumerate(got)]
        moved = [i for i, (y, x) in enumerate(zip(got, leaves)) if y is not x]
        sharding.reset_collective_stats()
        grads = torch.autograd.grad([got[i] for i in moved],
                                    [leaves[i] for i in moved],
                                    [cots[i] for i in moved])
        backward = sharding.collective_stats()["by_kind"]
        grads = dict(zip(moved, grads))
        grads = [grads.get(i, cots[i]) for i in range(len(LEAVES))]
        rest = [ctx.live_axes([a for a in ctx.mesh.axis_names
                               if a not in sharding.split_axes(f)])
                for f in fine]
        out[cap] = {
            "plain": plain, "gathered": [y.detach() for y in got],
            "grads": grads,
            "summed": [ctx.sum_over(g, r) for g, r in zip(grads, rest)],
            "reduced": sharding.reduce_blocks(cots, coarse, fine, ctx),
            "rest": rest, "no_grad": no_grad, "forward": forward,
            "backward": backward,
            "expected": _expected_counts(blocks, fine, coarse, ctx, cap)}
    return out


@pytest.fixture(scope="module")
def gathers():
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {_tag(s): pool.submit(spawn, _rank_gather, s, device="cpu",
                                     backend="gloo",
                                     timeout_s=SPAWN_TIMEOUT_S)
                for s in MESHES}
        return {tag: run.result() for tag, run in runs.items()}


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("cap", ["whole", "buckets"])
def test_the_gathers_backward_is_reduce_blocks_bitwise(gathers, shape, cap):
    """Each rank's gradient of its placed blocks through the gather equals
    `reduce_blocks` of the same cotangents bitwise: directly where every
    live axis places the leaf, after the sum over the axes that do not
    (two ranks: the order of a sum of two does not change its bytes)."""
    from repro_torch.sharding import BUCKET_ELEMS

    key = BUCKET_ELEMS if cap == "whole" else 1000
    for res in gathers[_tag(shape)]:
        run = res[key]
        for i, (g, s, want, rest) in enumerate(zip(
                run["grads"], run["summed"], run["reduced"], run["rest"])):
            got = s if rest else g
            assert got.dtype == want.dtype == LEAVES[i][1], i
            assert got.shape == want.shape and torch.equal(got, want), i
        assert any(run["rest"]) == (shape[1] > 1)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("cap", ["whole", "buckets"])
def test_the_gather_with_grad_gathers_what_the_no_grad_path_does(gathers,
                                                                 shape, cap):
    """The gathered blocks are the whole leaves' blocks under the coarse
    specs, with and without grad; the no-grad path makes exactly the
    all_gathers the specs count and no other collective, the grad path's
    forward the same, and its backward one all_to_all a bucket."""
    from repro_torch.sharding import BUCKET_ELEMS

    key = BUCKET_ELEMS if cap == "whole" else 1000
    for res in gathers[_tag(shape)]:
        run = res[key]
        for a, b in zip(run["plain"], run["gathered"]):
            assert a.dtype == b.dtype and torch.equal(a, b)
        gather, scatter = run["expected"]
        assert gather["calls"] > 0
        want = {"all-gather": gather} if gather["calls"] else {}
        assert run["no_grad"] == run["forward"] == want
        assert run["backward"] == {"all-to-all": scatter}
    if shape == (2, 2):
        whole, cut = (gathers["2x2"][0][k]["expected"][0]["calls"]
                      for k in (BUCKET_ELEMS, 1000))
        assert cut > whole


def _block_of(whole, spec, coord, sizes):
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        size = whole.shape[dim] // n
        whole = whole.narrow(dim, idx * size, size)
    return whole


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_the_gathered_blocks_are_the_coarse_blocks(gathers, shape):
    sizes = {"data": shape[0], "model": shape[1]}
    for res in gathers[_tag(shape)]:
        coord = dict(zip(("data", "model"), res["coordinate"]))
        gathered = res[1000]["gathered"]
        for i, (y, w) in enumerate(zip(gathered, res["wholes"])):
            want = _block_of(w, LEAVES[i][3], coord, sizes)
            assert torch.equal(y, want), i


# ----------------------------------------------------------------- the step


def _cfg(case):
    arch, over = OVERRIDES.get(case, (case, {}))
    return get_config(arch).reduced().replace(**F32, **over)


def _layer_and_top_bytes(model):
    """(the largest layer's gathered bytes, the top-level leaves'), from
    the specs: a leaf gathered to its block under the specs its ops
    compute with (its `model` split of a parallel axis kept), counted
    where that is not its placed block."""
    from repro_torch.models import lm
    from repro_torch.sharding import block_shape

    ctx, cfg = model.ctx, model.cfg

    def gathered(spec_tree):
        total = 0
        for s in tree.leaves(spec_tree):
            placed = ctx.spec(s.axes, s.shape)
            coarse = tuple(e if e == "model" and s.axes[d] in
                           lm.PARALLEL_AXES else None
                           for d, e in enumerate(placed))
            if block_shape(s.shape, placed, ctx) != block_shape(
                    s.shape, coarse, ctx):
                total += math.prod(block_shape(s.shape, coarse, ctx)) * \
                    torch.empty((), dtype=getattr(torch, s.dtype)
                                ).element_size()
        return total

    specs = lm.param_specs(cfg)
    layer = max(gathered(lm._layer_specs(cfg, cross=cfg.enc_dec)),
                gathered(lm._layer_specs(cfg)))
    top = sum(gathered(v) for k, v in specs.items()
              if k not in ("layers", "enc_layers"))
    return layer, top


def _batch(cfg):
    """Markov tokens over the text positions of 16, and an enc-dec arch's
    frame embeddings (a VLM's patch embeddings) over the front ones."""
    from repro_torch.configs import token_split
    from repro_torch.data import pipeline

    front, text = token_split(cfg, 16)
    task = pipeline.MarkovTask(pipeline.DataConfig(
        vocab=cfg.vocab, seq_len=text, global_batch=4))
    batch = {k: torch.from_numpy(v) for k, v in
             task.batch_for_step(0).items()}
    if front:
        batch["frames" if cfg.enc_dec else "patches"] = torch.from_numpy(
            np.random.RandomState(0).randn(4, front, cfg.d_model).astype(
                np.float32))
    return batch


def _rank_step(ctx):
    """One placed step of each arch on this rank, `steps.gather_params`
    made to raise, each gather's leaves watched: the peak of the gathered
    bytes alive at once, the gathers by size, the shapes gathered; the
    gradients of the placed blocks and, for the check, those of the
    serving layout reduced into them."""
    from repro_torch import sharding
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import steps

    torch.set_num_threads(1)
    real_gather = sharding._gather_blocks
    watch = {"alive": [], "peak": 0, "calls": [], "shapes": set()}

    def watched(xs, fine, coarse, ctx_):
        out = real_gather(xs, fine, coarse, ctx_)
        new = [y for x, y in zip(xs, out) if y is not x]
        watch["alive"] = [r for r in watch["alive"] if r() is not None]
        watch["alive"] += [weakref.ref(y) for y in new]
        live = sum(r().numel() * r().element_size() for r in watch["alive"]
                   if r() is not None)
        watch["peak"] = max(watch["peak"], live)
        watch["calls"].append(len(xs))
        if len(xs) > 1:                 # a layer's leaves
            watch["shapes"].update(tuple(y.shape) for y in new)
        return out

    def refused(*a, **k):
        raise AssertionError("the mesh step called gather_params")

    sharding._gather_blocks = watched
    real_gather_params = steps.gather_params
    out = {"coordinate": tuple(ctx.mesh.coordinate)}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg, ctx)
        gen = torch.Generator().manual_seed(0)
        whole = build_model(cfg).init(gen, "cpu")
        batch = steps.local_batch(ctx, _batch(cfg))
        placed = model.place(whole)
        steps.gather_params = refused
        watch.update(alive=[], peak=0, calls=[], shapes=set())
        try:
            _, grads = steps._loss_and_grads(model, placed, batch, 1)
            res = {"peak": watch["peak"], "calls": list(watch["calls"]),
                   "shapes": set(watch["shapes"]),
                   "budget": _layer_and_top_bytes(model)}
            state = init_state(model.place(whole))
            step = steps.jit_train_step(model, AdamWConfig(lr=1e-3))
            _, metrics = step(state, batch)
            res["loss"] = float(metrics["loss"])
        finally:
            steps.gather_params = real_gather_params
        held = steps.gather_params(model, placed)
        _, shares = steps.value_and_grad(model, held, batch)
        want = steps.reduce_grads(shares, model.held_param_specs(), ctx,
                                  model.param_partition_specs())
        res["grads"] = [g.detach() for g in tree.leaves(grads)]
        res["want"] = tree.leaves(want)
        res["placed_shapes"] = [tuple(x.shape) for x in tree.leaves(placed)]
        out[arch] = res
    sharding._gather_blocks = real_gather
    return out


@pytest.fixture(scope="module")
def placed_steps():
    from concurrent.futures import ThreadPoolExecutor

    shapes = [(1, 2), (2, 2)]
    with ThreadPoolExecutor(len(shapes)) as pool:
        runs = {_tag(s): pool.submit(spawn, _rank_step, s, device="cpu",
                                     backend="gloo",
                                     timeout_s=SPAWN_TIMEOUT_S)
                for s in shapes}
        return {tag: run.result() for tag, run in runs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_the_mesh_step_gathers_a_layer_at_a_time(placed_steps, arch):
    """On (2, 2), where every leaf is placed over `data`: never
    `gather_params`; at most one layer's gathered leaves and the
    top-level ones alive at once, and at least one layer's; each layer
    (an encoder's too) gathered in its forward and again in its
    recompute, one call a layer; a finite loss from `jit_train_step`
    too."""
    cfg = _cfg(arch)
    for res in placed_steps["2x2"]:
        run = res[arch]
        layer, top = run["budget"]
        assert layer > 0 and top > 0
        assert layer <= run["peak"] <= layer + top, (run["peak"], layer, top)
        layer_calls = [n for n in run["calls"] if n > 1]
        assert len(layer_calls) == 2 * (cfg.n_layers + cfg.n_enc_layers)
        assert math.isfinite(run["loss"])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_mesh_steps_gradients_are_the_placed_blocks(placed_steps, shape,
                                                        arch):
    """Each gradient has its placed block's shape and equals, within
    2e-5 (`ROUNDED` archs: or within 1e-3 of the leaf's largest entry), the
    serving layout's gradient shares reduced into the block
    (`reduce_grads` with the placed specs, the step before this one)."""
    for res in placed_steps[shape]:
        run = res[arch]
        assert [tuple(g.shape) for g in run["grads"]] == run["placed_shapes"]
        for i, (g, w) in enumerate(zip(run["grads"], run["want"])):
            err = float((g - w).abs().max()) if g.numel() else 0.0
            bound = max(GRAD_TOL, GRAD_RTOL * float(w.abs().max())) \
                if arch in ROUNDED and w.numel() else GRAD_TOL
            assert err <= bound, (i, err, bound)


def test_attention_and_the_mlp_run_split_over_model(placed_steps):
    """yi-6b on (2, 2): the layer's `wq`, `wo` and MLP weights reach it
    gathered over `data` and split over `model` (half the heads, half the
    MLP's width), never whole (the shapes a layer's gathers give)."""
    cfg = _cfg("yi-6b")
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff
    for res in placed_steps["2x2"]:
        shapes = res["yi-6b"]["shapes"]
        assert {(d, h // 2, hd), (h // 2, hd, d), (d, f // 2),
                (f // 2, d)} <= shapes
        assert not {(d, h, hd), (h, hd, d), (d, f), (f, d)} & shapes


# ------------------------------------------------------ the vocab-split loss


def _rank_xent(ctx, vocab):
    """`_xent_split` of this rank's block of logits drawn whole from a
    seed, its gradient under the sum convention (the backward seeded with
    1 / model), and `_xent` of the whole logits with its gradient."""
    from repro_torch.models import lm
    from repro_torch.sharding import local_shard

    torch.set_num_threads(1)
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.standard_normal((3, 5, vocab)).astype(
        np.float32) * 4)
    targets = torch.from_numpy(rng.randint(0, vocab, (3, 5)).astype(np.int32))
    whole = logits.clone().requires_grad_(True)
    want = lm._xent(whole, targets)
    (want_grad,) = torch.autograd.grad(want, whole)
    mine = local_shard(logits, (None, None, "model"), ctx).clone() \
        .requires_grad_(True)
    got = lm._xent_split(mine, targets, ctx)
    (grad,) = torch.autograd.grad(
        got, mine, torch.full_like(got, 1.0 / ctx.axis_sizes["model"]))
    return {"got": got.detach(), "want": want.detach(), "grad": grad,
            "want_grad": local_shard(want_grad, (None, None, "model"), ctx)}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=_tag)
def test_the_vocab_parallel_loss_is_xent_of_the_whole_logits(shape):
    for res in spawn(functools.partial(_rank_xent, vocab=96), shape,
                     device="cpu", backend="gloo",
                     timeout_s=SPAWN_TIMEOUT_S):
        assert abs(float(res["got"]) - float(res["want"])) <= XENT_TOL
        assert float((res["grad"] - res["want_grad"]).abs().max()) <= \
            XENT_TOL


# ------------------------------------------------------------ AdamW in runs


@pytest.mark.parametrize("run_bytes", [64 << 20, 4096])
def test_adamw_in_runs_on_a_mesh_is_bitwise_the_whole_update(monkeypatch,
                                                             run_bytes):
    """`apply_updates_` on a mesh takes a leaf in runs of its leading axis
    (three runs of the [24, 8, 16] leaf at 4096 bytes, the others whole):
    every leaf of the state, the learning rate and the norm bitwise those
    of `apply_updates`, the functional update of each leaf whole."""
    from repro_torch.optim import adamw
    from repro_torch.sharding import Mesh, ShardingCtx

    monkeypatch.setattr(adamw, "UPDATE_RUN_BYTES", run_bytes)
    gen = torch.Generator().manual_seed(5)

    def draw(shape):
        return torch.randn(shape, generator=gen)

    shapes = {"a": (24, 8, 16), "b": (50, 7), "c": (3,)}
    params = {k: draw(s) for k, s in shapes.items()}
    grads = {k: draw(s) for k, s in shapes.items()}
    state = {"step": torch.tensor(2, dtype=torch.int32), "params": params,
             "mu": {k: draw(s).abs() for k, s in shapes.items()},
             "nu": {k: draw(s).abs() for k, s in shapes.items()}}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (1, 1)))
    want, want_m = adamw.apply_updates(state, grads, cfg, ctx=ctx)
    runs = [len(list(adamw._runs(leaf, ctx)))
            for leaf in adamw._leaves(state, grads)]
    assert runs == ([3, 1, 1] if run_bytes == 4096 else [1, 1, 1])
    mine = tree.map_tree(torch.clone, state)
    got_m = adamw.apply_updates_(mine, grads, cfg, ctx=ctx)
    for a, b in zip(tree.leaves(mine), tree.leaves(want)):
        assert torch.equal(a, b)
    for name in ("lr", "grad_norm"):
        assert torch.equal(got_m[name], want_m[name])
