"""Self-contained AdamW with a warmup-cosine schedule: the reference
package's ``optim/adamw.py``.

Parameters are stored in f32 and cast to the compute type inside the model,
so the optimizer state is exactly (step, params, mu, nu). The update is the
reference's: a global-norm clip of the gradients, the warmup-cosine
learning rate, decoupled weight decay on every leaf, f32 moments. It is
not ``torch.optim.AdamW``, whose clip and schedule are not these. Trees
are nested dicts of tensors (`core.tree`); `apply_updates` returns a new
state and leaves the old one as it was; `apply_updates_` writes the same
update into the state's own tensors (the train step's CUDA graph). On a
mesh the global norm counts every element of the gradients once
(`global_norm`), so that every rank clips alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import tree
from repro_torch.sharding import NULL_CTX, ShardingCtx, split_axes

__all__ = ["AdamWConfig", "apply_updates", "apply_updates_", "global_norm",
           "init_state", "lr_schedule"]

# On a mesh `apply_updates_` updates a leaf in runs of its leading axis of
# at most this many bytes of f32: the same elementwise arithmetic, with
# each temporary (up to ~9 alive at once, each of the run's size) a run's,
# so that the update does not set a rank's peak memory. The mesh step is
# eager; the one-device step, a CUDA graph, updates each leaf whole.
UPDATE_RUN_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or an integer tensor), as an f32
    0-d tensor on the step's device: linear warmup, then a cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_state(params) -> Dict[str, Any]:
    """Step 0 and zero moments of the parameters' shapes and types, on
    their devices."""
    first = tree.leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "params": params,
        "mu": tree.map_tree(torch.zeros_like, params),
        "nu": tree.map_tree(torch.zeros_like, params),
    }


def global_norm(grads, ctx: ShardingCtx = NULL_CTX, specs=None
                ) -> torch.Tensor:
    """The f32 L2 norm over every leaf of a gradient tree. On a mesh,
    `specs` (a tree of partition specs of the gradients' structure: what
    each rank holds) says which leaves are a rank's block of a split one:
    their squares are summed over the axes that split them, so that each
    element counts once; a whole leaf counts once, from this rank's copy.
    Every rank then holds the same norm."""
    if ctx.mesh is None or specs is None:
        total = sum(torch.sum(torch.square(g.float()))
                    for g in tree.leaves(grads))
        return torch.sqrt(total)
    by_axes: Dict[Tuple[str, ...], Any] = {}
    for g, spec in zip(tree.leaves(grads), tree.leaves(specs)):
        key = split_axes(spec)
        by_axes[key] = by_axes.get(key, 0) + torch.sum(torch.square(g.float()))
    total = sum(ctx.sum_over(sq, axes) for axes, sq in sorted(by_axes.items()))
    return torch.sqrt(total)


def _update_scalars(state: Dict[str, Any], grads, cfg: AdamWConfig,
                    ctx: ShardingCtx, specs):
    """(step + 1, its learning rate, the gradients' global norm, the clip
    scale, the two bias corrections): what every leaf's update reads."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads, ctx, specs)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else 1.0)
    c1 = 1 - cfg.b1 ** step.float()
    c2 = 1 - cfg.b2 ** step.float()
    return step, lr, gnorm, scale, c1, c2


def _update_leaf(p, g, mu, nu, lr, scale, c1, c2, cfg: AdamWConfig):
    """One leaf's AdamW update: (new p, new mu, new nu), new tensors."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    step_dir = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
    p = p - lr * (step_dir + cfg.weight_decay * p)
    return p, mu, nu


def _leaves(state: Dict[str, Any], grads):
    return zip(tree.leaves(state["params"]), tree.leaves(grads),
               tree.leaves(state["mu"]), tree.leaves(state["nu"]))


@torch.no_grad()
def apply_updates(state: Dict[str, Any], grads, cfg: AdamWConfig, *,
                  ctx: ShardingCtx = NULL_CTX, specs=None):
    """One AdamW step. Returns (new_state, {"lr", "grad_norm"}). On a mesh
    `grads` are the reduced gradients of the leaves this rank holds and
    `specs` their partition specs (`global_norm`)."""
    step, lr, gnorm, *coef = _update_scalars(state, grads, cfg, ctx, specs)
    out = [_update_leaf(*leaf, lr, *coef, cfg)
           for leaf in _leaves(state, grads)]
    template = state["params"]
    new_state = {
        "step": step,
        "params": tree.unflatten(template, [o[0] for o in out]),
        "mu": tree.unflatten(template, [o[1] for o in out]),
        "nu": tree.unflatten(template, [o[2] for o in out]),
    }
    return new_state, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def apply_updates_(state: Dict[str, Any], grads, cfg: AdamWConfig, *,
                   ctx: ShardingCtx = NULL_CTX, specs=None
                   ) -> Dict[str, torch.Tensor]:
    """`apply_updates` written into the state's own tensors: the same
    arithmetic, leaf by leaf, each leaf's new params, mu and nu copied
    into its old ones, and the step advanced in place. The counterpart of
    the reference's donated state: a CUDA graph of the train step keeps
    no second copy of params, mu and nu. On a mesh each leaf goes in runs
    along its leading axis (`UPDATE_RUN_BYTES`), bitwise the same update.
    Returns {"lr", "grad_norm"}."""
    step, lr, gnorm, *coef = _update_scalars(state, grads, cfg, ctx, specs)
    for leaf in _leaves(state, grads):
        for p, g, mu, nu in _runs(leaf, ctx):
            new_p, new_mu, new_nu = _update_leaf(p, g, mu, nu, lr, *coef,
                                                 cfg)
            p.copy_(new_p)
            mu.copy_(new_mu)
            nu.copy_(new_nu)
    state["step"].copy_(step)
    return {"lr": lr, "grad_norm": gnorm}


def _runs(leaf, ctx: ShardingCtx):
    """A leaf's (p, g, mu, nu), whole, or on a mesh in runs of its leading
    axis of at most `UPDATE_RUN_BYTES` of f32 (views)."""
    p = leaf[0]
    if ctx.mesh is None or p.dim() == 0:
        return [leaf]
    rows = max(1, p.shape[0] * UPDATE_RUN_BYTES // max(4 * p.numel(), 1))
    if rows >= p.shape[0]:
        return [leaf]
    return zip(*(x.split(rows) for x in leaf))
