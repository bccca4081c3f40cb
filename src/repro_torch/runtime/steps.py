"""Step builders: train / prefill / decode, one per shape-suite kind (the
reference package's ``runtime/steps.py`` on one device).

The train step differentiates `Model.loss` with `torch.autograd` and applies
AdamW. Gradient accumulation is a Python loop over microbatches (the
reference's ``lax.scan``) with the same f32 mean of gradients and losses.
`make_train_step` is the functional step, run eagerly (the reference's
`make_train_step`). `jit_train_step` is the reference's mesh-less
``jax.jit(step, donate_argnums=(0,))``: the same arithmetic, written into
the state's own tensors and replayed as one CUDA graph
(`core/step_graph.py`). The sharding helpers give the batch's and the
state's partition specs and the state's meta tensors; training on a mesh
(the reference's mesh branch of its jitted step) is not ported yet:
`jit_train_step` refuses a model with a mesh (ROADMAP item 3b).
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
from repro_torch.sharding import ShardingCtx

__all__ = ["MESH_TRAIN_REFUSED", "abstract_state", "batch_shardings",
           "jit_train_step", "make_decode_step", "make_prefill_step",
           "make_train_step", "state_shardings", "value_and_grad"]

MESH_TRAIN_REFUSED = ("training on a device mesh (compressed_psum, the "
                      "parameters placed by their rules, the jitted step's "
                      "mesh branch) is not ported yet: ROADMAP Queue 1, "
                      "item 3b")


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


def abstract_state(model: Model):
    """The train state as meta tensors (no memory)."""
    p = model.abstract_params()
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "params": p, "mu": p, "nu": p}


def value_and_grad(model: Model, params, batch) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of `model.loss` at `params`: the parameters
    are differentiated as detached leaves (no copy), so `params` itself
    never requires grad. A parameter the loss does not reach gets a zero
    gradient, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, leaves)
    with torch.enable_grad():
        loss, _ = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def _loss_and_grads(model: Model, params, batch, accum: int):
    """(loss, gradients) of one step: of the whole batch, or the f32 means
    over `accum` microbatches cut along the batch's leading axis."""
    if accum == 1:
        return value_and_grad(model, params, batch)
    gsum = tree.map_tree(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    lsum = 0.0
    for i in range(accum):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        loss, g = value_and_grad(model, params, mb)
        gsum = tree.map_tree(torch.add, gsum, g)
        lsum = lsum + loss
    return lsum / accum, tree.map_tree(lambda g: g / accum, gsum)


def make_train_step(model: Model, opt: AdamWConfig, *, accum: int = 1,
                    compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics); `batch` is a
    dict of tensors on the parameters' device, split into `accum`
    microbatches along its leading axis. With `compress` the gradients go
    through `ef_compress` against ``state["grad_error"]`` before the update
    (the reference train loop's compressed step) and the new state holds
    the new error. The caller's state is left as it was."""

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        loss, grads = _loss_and_grads(model, state["params"], batch, accum)
        if compress:
            grads, err = ef_compress(grads, state["grad_error"])
        new_state, opt_metrics = apply_updates(state, grads, opt)
        if compress:
            new_state["grad_error"] = err
        return new_state, {"loss": loss, **opt_metrics}

    return train_step


def jit_train_step(model: Model, opt: AdamWConfig, *, accum: int = 1,
                   compress: bool = False, donate: bool = True):
    """The reference's jitted, donated train step on one device (its
    ``runtime/steps.py:jit_train_step`` without a mesh, and the train
    loop's ``jax.jit(step_fn, donate_argnums=(0,))``). Returns
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

    A model with a mesh raises NotImplementedError (`MESH_TRAIN_REFUSED`)."""
    if model.ctx.mesh is not None:
        raise NotImplementedError(MESH_TRAIN_REFUSED)
    names: List[str] = []
    own: Dict[str, Any] = {}

    def train_fn(state: Dict[str, Any], *values: torch.Tensor):
        batch = dict(zip(names, values))
        loss, grads = _loss_and_grads(model, state["params"], batch, accum)
        if compress:
            grads = ef_compress_(grads, state["grad_error"])
        return {"loss": loss, **apply_updates_(state, grads, opt)}

    graph = StepGraph(train_fn, "train_step")

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
        metrics = graph((state,), [batch[k] for k in names])
        return state, metrics

    step.graph = graph
    return step


def make_prefill_step(model: Model, *, pad_to: Optional[int] = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, pad_to=pad_to)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)
    return decode_step
