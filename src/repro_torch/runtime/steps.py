"""Step builders: train / prefill / decode, one per shape-suite kind (the
reference package's ``runtime/steps.py``).

The train step differentiates `Model.loss` with `torch.autograd` and applies
AdamW. Gradient accumulation is a Python loop over microbatches (the
reference's ``lax.scan``) with the same f32 mean of gradients and losses.
`make_train_step` is the functional step, run eagerly (the reference's
`make_train_step`). `jit_train_step` is the reference's jitted, donated
step: without a mesh the same arithmetic, written into the state's own
tensors and replayed as one CUDA graph (`core/step_graph.py`); on a
running mesh (one process a rank, `launch.mesh.spawn`) the same step run
eagerly on every rank.

On a mesh each rank holds its rows of the batch (`local_batch`) and its
block of the train state placed by the rules (`state_shardings`: params,
mu, nu and, with compression, the error state, each leaf split over the
mesh axes its logical axes map to; `Model.place` cuts a whole tree), as
the reference's jitted step holds it, and the step computes on those
blocks, as the reference's GSPMD step does: the loss is differentiated
at the placed blocks themselves. Each layer's leaves are gathered over
the axes that place them and that no op computes in parallel just before
the layer, inside its remat, and again in the recompute (`models.lm`);
attention, the MLP, the embedding, the logits and the loss run
tensor-parallel over `model`, the MoE expert-parallel; the gather's
backward reduce-scatters each gradient into the rank's block. No rank
holds the whole parameters. The step follows the sum convention of
`sharding`: each rank's backward is seeded with 1 / (the mesh's ranks),
its share of the loss's mean, so that what the backward leaves on a
placed block is the sum over the ranks that gathered it, and
`reduce_grads` sums it over the mesh axes that do not place the leaf
(every axis for a leaf placed whole, ``data`` for one split over `model`
only). The logged loss is the mean over the ranks, the global loss; the
global norm counts every element once (`optim.adamw.global_norm`), and
compression quantizes each leaf with its whole max. AdamW updates each
rank's blocks; a block that several ranks hold gets the same reduced
bytes on each, so the copies stay equal with no broadcast. The sharding
helpers give the batch's and the state's partition specs and the state's
meta tensors; `gather_params` and the held form of `reduce_grads` take a
placed tree to the serving layout and shares there back.

The serving steps: `make_prefill_step` and `make_decode_step` (the
functional steps), and the reference's placed steps, `jit_prefill_step`
(the prefill its dry-run jits) and `jit_decode_step(model, shape)`, which
on a running mesh take the parameters placed by `Model.param_shardings`
and the caches by `Model.cache_shardings(shape)`, in and out, and run
eagerly; without a mesh `jit_decode_step` is the one-device step every
serving loop reuses (a CUDA graph on the card).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.shapes import Spec
from repro_torch.core import tree
from repro_torch.core.step_graph import StepGraph
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWConfig, apply_updates, apply_updates_
from repro_torch.optim.compression import ef_compress, ef_compress_
from repro_torch.sharding import (ShardingCtx, block_shape, gather_blocks,
                                  local_shard, reduce_blocks)

__all__ = ["abstract_state", "batch_shardings", "gather_params",
           "held_state_specs", "jit_decode_step", "jit_prefill_step",
           "jit_train_step", "local_batch", "make_decode_step",
           "make_prefill_step", "make_train_step", "reduce_grads",
           "state_shardings", "value_and_grad"]


# ----------------------------------------------------------------- sharding


def batch_shardings(ctx: ShardingCtx, specs: Dict[str, Spec]):
    """Each input's partition spec: its leading axis over ``batch``. None
    without a mesh, as in the reference."""
    if ctx.mesh is None:
        return None
    return {k: ctx.spec(["batch"] + [None] * (len(v.shape) - 1), v.shape)
            for k, v in specs.items()}


def state_shardings(model: Model):
    """The train state's partition specs: the parameters' (by their rules)
    for params, mu and nu, the step replicated. None without a mesh."""
    if model.ctx.mesh is None:
        return None
    ps = model.param_partition_specs()
    return {"step": (), "params": ps, "mu": ps, "nu": ps}


def held_state_specs(model: Model, state: Dict[str, Any]):
    """What each rank holds of every leaf of a train state on a mesh:
    `state_shardings`' specs for params, mu, nu and, with compression,
    grad_error (the parameters' partition specs); the step whole."""
    ps = model.param_partition_specs()
    return {k: (() if k == "step" else ps) for k in state}


def local_batch(ctx: ShardingCtx, batch: Dict[str, torch.Tensor],
                accum: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (the batch itself without a
    mesh). The batch is cut into `accum` microbatches along its leading
    axis, as the reference's step cuts it, and the rank takes its block of
    each (`batch_shardings`' spec of a microbatch), so that microbatch i of
    the rank's rows is its shard of the reference's microbatch i. A
    microbatch that does not split over ``batch``'s axes is held whole."""
    if ctx.mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        mbs = v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
        spec = ctx.spec(["batch"] + [None] * (v.ndim - 1), mbs.shape[1:])
        out[k] = local_shard(mbs, (None,) + spec, ctx).reshape(
            -1, *v.shape[1:])
    return out


def _mesh_specs(model: Model):
    """On a running mesh (None without a mesh; a mesh of shapes alone
    raises RuntimeError): (the specs the model computes with, the placed
    specs, the placed blocks' shapes), the specs as trees, the shapes a
    list in the leaves' order."""
    ctx = model.ctx
    if ctx.mesh is None:
        return None
    ctx._running()
    placed = model.param_partition_specs()
    shapes = [block_shape(p.shape, spec, ctx) for p, spec in
              zip(tree.leaves(model.param_specs()), tree.leaves(placed))]
    return model.held_param_specs(), placed, shapes


def _placed_specs(model: Model):
    """The placed specs on a running mesh, else None."""
    specs = _mesh_specs(model)
    return None if specs is None else specs[1]


def _check_blocks(params, shapes) -> None:
    """Raise ValueError unless every leaf of `params` has its placed
    block's shape (`shapes`, in the leaves' order)."""
    got = [tuple(x.shape) for x in tree.leaves(params)]
    if got != shapes:
        bad = next(i for i, (a, b) in enumerate(zip(got, shapes)) if a != b)
        raise ValueError(f"parameter leaf {bad} is held as {got[bad]}; its "
                         f"placed block is {shapes[bad]} (Model.place cuts "
                         "the whole parameters)")


def gather_params(model: Model, params):
    """This rank's placed blocks of the parameters -> the serving layout
    (`Model.held_param_specs`): each leaf gathered over the axes that
    place it and that serving does not split it along (every axis for a
    whole leaf; ``data`` for an expert leaf). One all_gather a group of
    leaves (`sharding.gather_blocks`). The parameters themselves without
    a mesh. The train step does not call it: it computes on the blocks."""
    specs = _mesh_specs(model)
    if specs is None:
        return params
    compute, placed, shapes = specs
    _check_blocks(params, shapes)
    return tree.unflatten(params, gather_blocks(
        tree.leaves(params), tree.leaves(placed), tree.leaves(compute),
        model.ctx))


def reduce_grads(grads, specs, ctx: ShardingCtx, placed=None):
    """Each rank's gradient shares at the blocks of `specs` -> the
    gradients: a leaf's shares summed over the mesh axes that `specs` does
    not split it along (a whole leaf over every axis, a leaf split over
    `model` alone over `data`). The train step hands it the placed blocks
    its backward leaves, with the placed specs. With `placed` (specs that
    split each leaf at least as `specs` does: shares at the serving
    layout) each rank keeps its placed block, the axes that place it
    reduce-scattered (`sharding.reduce_blocks`). One collective a group of
    leaves (a bucket of a large one), as one flat f32 buffer."""
    placed = specs if placed is None else placed
    return tree.unflatten(grads, reduce_blocks(
        tree.leaves(grads), tree.leaves(specs), tree.leaves(placed), ctx))


def abstract_state(model: Model):
    """The train state as meta tensors (no memory)."""
    p = model.abstract_params()
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "params": p, "mu": p, "nu": p}


def value_and_grad(model: Model, params, batch) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of `model.loss` at `params`: the parameters
    are differentiated as detached leaves (no copy), so `params` itself
    never requires grad. A parameter the loss does not reach gets a zero
    gradient, as under ``jax.grad``. On a mesh: this rank's loss (of its
    rows) and its gradient shares, the backward seeded with 1 / (the
    mesh's ranks); `reduce_grads` makes them the gradients. Placed
    parameters give gradients of the same blocks."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, leaves)
    with torch.enable_grad():
        loss, _ = model.loss(live, batch)
        seed = None if model.ctx.mesh is None else \
            torch.full_like(loss, 1.0 / model.ctx.mesh.size)
        grads = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def _loss_and_grads(model: Model, params, batch, accum: int):
    """(loss, gradients) of one step: of the whole batch, or the f32 means
    over `accum` microbatches cut along the batch's leading axis. On a
    mesh `params` are this rank's placed blocks (another layout raises
    ValueError), differentiated as they are: each layer gathers its
    leaves inside its remat and its backward reduce-scatters their
    gradients into the blocks (`models.lm`), so the loss is of the rank's
    rows and each gradient the rank's placed block, accumulated in f32,
    then summed over the axes that do not place it (`reduce_grads`); the
    loss is the mean over the ranks, the global loss."""
    specs = _mesh_specs(model)
    if specs is not None:
        _, placed, shapes = specs
        _check_blocks(params, shapes)
    if accum == 1:
        loss, grads = value_and_grad(model, params, batch)
    else:
        gsum = tree.map_tree(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        lsum = 0.0
        for i in range(accum):
            mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, g = value_and_grad(model, params, mb)
            gsum = tree.map_tree(torch.add, gsum, g)
            lsum = lsum + loss
        loss, grads = lsum / accum, tree.map_tree(lambda g: g / accum, gsum)
    if specs is None:
        return loss, grads
    return model.ctx.mean_all(loss), reduce_grads(grads, placed, model.ctx)


def make_train_step(model: Model, opt: AdamWConfig, *, accum: int = 1,
                    compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics); `batch` is a
    dict of tensors on the parameters' device, split into `accum`
    microbatches along its leading axis. With `compress` the gradients go
    through `ef_compress` against ``state["grad_error"]`` before the update
    (the reference train loop's compressed step) and the new state holds
    the new error. The caller's state is left as it was. On a running mesh
    `batch` is the rank's rows (`local_batch`) and the state its placed
    blocks (`held_state_specs`)."""
    ctx, specs = model.ctx, _placed_specs(model)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        loss, grads = _loss_and_grads(model, state["params"], batch, accum)
        if compress:
            grads, err = ef_compress(grads, state["grad_error"], ctx, specs)
        new_state, opt_metrics = apply_updates(state, grads, opt, ctx=ctx,
                                               specs=specs)
        if compress:
            new_state["grad_error"] = err
        return new_state, {"loss": loss, **opt_metrics}

    return train_step


def jit_train_step(model: Model, opt: AdamWConfig, *, accum: int = 1,
                   compress: bool = False, donate: bool = True):
    """The reference's jitted, donated train step (its
    ``runtime/steps.py:jit_train_step``, and the train loop's
    ``jax.jit(step_fn, donate_argnums=(0,))``). Returns
    step(state, batch) -> (state, metrics), `make_train_step`'s arithmetic
    with the update written into the state's own tensors
    (`apply_updates_`, and `ef_compress_` into ``state["grad_error"]``
    when `compress`), run by a `StepGraph` named ``train_step``
    (``step.graph``).

    On CUDA tensors the first call at a key (the batch's shapes and types,
    the state's addresses) is a real step run eagerly, then the capture of
    the whole step: forward, backward through K2's and K4's
    `autograd.Function`s, accumulation, compression, AdamW. Every later
    call copies the batch (host or device tensors) into the graph's
    buffers and replays it. The step's count and learning rate are read on
    the device, so each replay advances them. `metrics` holds 0-d tensors
    (``loss``, ``lr``, ``grad_norm``): the graph's outputs, rewritten by
    the next call, so read them before it. On CPU tensors every call is
    the same step run eagerly.

    ``donate=True`` (the train loop's): the returned state is the caller's
    dict, updated in place, its keys and tensors the same objects.
    ``donate=False``: the step keeps a state of its own and copies the
    caller's into it before every call, one copy of the whole state a step
    (params, mu, nu, and the error state with `compress`); the caller's
    tensors stay as they were, and the returned state is the step's own,
    rewritten by its next call.

    On a model whose `ctx` holds a running mesh (a mesh of shapes alone
    raises RuntimeError), every call is the step run eagerly on this
    rank: `batch` is its rows (`local_batch`), the state its placed blocks
    (`held_state_specs`), differentiated as they are (each layer's leaves
    gathered inside its remat and again in the recompute, the dense
    projections tensor-parallel over `model`, each gradient reduce-
    scattered into its block by the gather's backward and summed over the
    axes that do not place it) before compression and AdamW (updated in
    place on the blocks), and ``step.graph`` is None. No CUDA graph is
    captured there: gloo's collectives run on the host and cannot be
    captured, and NCCL cannot put two ranks on one card, which is how one
    card runs a mesh."""
    ctx, specs = model.ctx, _placed_specs(model)
    names: List[str] = []
    own: Dict[str, Any] = {}

    def train_fn(state: Dict[str, Any], *values: torch.Tensor):
        batch = dict(zip(names, values))
        loss, grads = _loss_and_grads(model, state["params"], batch, accum)
        if compress:
            grads = ef_compress_(grads, state["grad_error"], ctx, specs)
        return {"loss": loss, **apply_updates_(state, grads, opt, ctx=ctx,
                                               specs=specs)}

    if ctx.mesh is None:
        graph = run = StepGraph(train_fn, "train_step")
    else:
        graph = None

        def run(args, values):
            return train_fn(*args, *(v.to(ctx.device) for v in values))

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        if not names:
            names.extend(sorted(batch))
        if sorted(batch) != names:
            raise ValueError(f"train step: batch keys {sorted(batch)}, "
                             f"the step's are {names}")
        if not donate:
            if not own:
                own["state"] = tree.map_tree(torch.clone, state)
            else:
                for mine, theirs in zip(tree.leaves(own["state"]),
                                        tree.leaves(state)):
                    if mine is not theirs:
                        mine.copy_(theirs)
            state = own["state"]
        metrics = run((state,), [batch[k] for k in names])
        return state, metrics

    step.graph = graph
    return step


def make_prefill_step(model: Model, *, pad_to: Optional[int] = None):
    """Returns prefill_step(params, batch) -> (cache, last logits). The
    cache comes out in the layout of the parameters it is handed
    (`models.lm.prefill`): placed parameters give the caches placed as
    `Model.cache_shardings` places them (the reference dry-run's prefill,
    whose ``out_shardings`` are those)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, pad_to=pad_to)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)
    return decode_step


def _placed_blocks(model: Model, wholes, specs):
    """The placed block shape of each leaf of `wholes` (meta tensors)
    under `specs`, keyed by its path, for `_check_placed`."""
    return {path: block_shape(w.shape, spec, model.ctx) for (path, w), spec in
            zip(tree.paths(wholes), tree.leaves(specs))}


def _check_placed(what: str, got, want) -> None:
    """Raise ValueError unless every leaf of `got` has its placed block's
    shape in `want` (`_placed_blocks`)."""
    paths = dict(tree.paths(got))
    if set(paths) != set(want):
        raise ValueError(f"{what}: leaves {sorted(map('/'.join, paths))}, "
                         f"the placed tree's {sorted(map('/'.join, want))}")
    for path, x in paths.items():
        if tuple(x.shape) != want[path]:
            raise ValueError(f"{what} leaf {'/'.join(path)} is held as "
                             f"{tuple(x.shape)}; its placed block is "
                             f"{want[path]}")


def _placed_params(model: Model):
    return _placed_blocks(model, model.abstract_params(),
                          model.param_shardings())


def jit_prefill_step(model: Model, *, pad_to: Optional[int] = None):
    """The placed prefill the reference's dry-run jits (``in_shardings`` the
    parameters' and the batch's, ``out_shardings`` the cache's): returns
    step(params, batch) -> (cache, last logits). On a running mesh
    `params` are this rank's blocks by `Model.param_shardings` (another
    layout raises ValueError), `batch` its rows (`local_batch`), and the
    cache comes back placed as `Model.cache_shardings` places it, with
    the whole K/V caches' lengths under ``"kv_len"``; the step runs
    eagerly (gloo's collectives cannot be captured). Without a mesh it is
    `Model.prefill`, as the serving launcher runs it."""
    ctx = model.ctx
    fn = make_prefill_step(model, pad_to=pad_to)
    if ctx.mesh is None:
        return fn
    ctx._running()
    want = _placed_params(model)

    def step(params, batch):
        _check_placed("placed prefill params", params, want)
        return fn(params, batch)

    return step


def _one_device_decode_step(model: Model):
    """`jit_decode_step` without a mesh, as the reference's
    ``jax.jit(model.decode_step, donate_argnums=(1,))``: the same call as
    `model.decode_step` (params, cache, batch) -> (logits, cache).

    On CUDA tensors each call replays a CUDA graph of `model.decode_step`
    (`core.step_graph.StepGraph`), captured at the first call for these
    parameters, caches and batch shape, and again whenever one of them
    changes; the caches are updated in place, as the reference donates
    them. The logits and the cache's ``pos`` it returns are the graph's
    output buffers: the next call overwrites them, so a caller reads them
    first (`launch.serve.timed_decode_loop` takes the argmax and scans the
    logits before its next call). On CPU tensors it is
    `model.decode_step`, run eagerly. The graph is the function's
    ``graph`` attribute."""

    def step(params, layers, pos, tokens):
        return model.decode_step(params, {"pos": pos, "layers": layers},
                                 {"tokens": tokens})

    graph = StepGraph(step, "dense_decode")

    def decode(params, cache, batch):
        return graph((params, cache["layers"]),
                     (cache["pos"], batch["tokens"]))

    decode.graph = graph
    return decode


def jit_decode_step(model: Model, shape=None):
    """The reference's ``jit_decode_step(model, shape)``: step(params,
    cache, batch) -> (logits, cache), the cache updated in place (the
    reference donates it).

    On a running mesh the parameters are this rank's blocks by
    `Model.param_shardings` and the cache its blocks by
    `Model.cache_shardings(shape)` (`jit_prefill_step` gives them, or
    `Model.place_cache`), in and out; a leaf held otherwise raises
    ValueError. Each layer's leaves are gathered over `data` just before
    the layer; attention and the MLP are tensor-parallel over `model`,
    the MoE expert-parallel (`models.lm`). The step runs eagerly on every
    rank: gloo's collectives cannot be captured in a CUDA graph. Without a
    mesh `shape` is not read, and the step is the one every serving loop
    reuses (`_one_device_decode_step`: a CUDA graph on the card)."""
    ctx = model.ctx
    if ctx.mesh is None:
        return _one_device_decode_step(model)
    if shape is None:
        raise ValueError("jit_decode_step on a mesh needs the shape suite "
                         "whose caches it holds (Model.cache_shardings)")
    ctx._running()
    fn = make_decode_step(model)
    want = _placed_params(model)
    whole = model.abstract_cache(shape)
    want_cache = _placed_blocks(model, whole["layers"],
                                model.cache_shardings(shape)["layers"])

    def step(params, cache, batch):
        _check_placed("placed decode params", params, want)
        _check_placed("placed decode cache", cache["layers"], want_cache)
        logits, new = fn(params, cache, batch)
        _check_placed("placed decode cache", new["layers"], want_cache)
        return logits, new

    return step
