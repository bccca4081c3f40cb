"""Step builders: train / prefill / decode, one per shape-suite kind (the
reference package's ``runtime/steps.py`` on one device).

The train step differentiates `Model.loss` with `torch.autograd` and applies
AdamW. Gradient accumulation is a Python loop over microbatches (the
reference's ``lax.scan``) with the same f32 mean of gradients and losses.
The step runs eagerly; the sharding helpers come with the multi-device
work, and capturing the train step as a CUDA graph is later work (ROADMAP).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import tree
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWConfig, apply_updates

__all__ = ["make_decode_step", "make_prefill_step", "make_train_step",
           "value_and_grad"]


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


def make_train_step(model: Model, opt: AdamWConfig, *, accum: int = 1):
    """Returns train_step(state, batch) -> (state, metrics); `batch` is a
    dict of tensors on the parameters' device, split into `accum`
    microbatches along its leading axis."""

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if accum > 1:
            gsum = tree.map_tree(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            lsum = 0.0
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss, g = value_and_grad(model, params, mb)
                gsum = tree.map_tree(torch.add, gsum, g)
                lsum = lsum + loss
            grads = tree.map_tree(lambda g: g / accum, gsum)
            loss = lsum / accum
        else:
            loss, grads = value_and_grad(model, params, batch)
        new_state, opt_metrics = apply_updates(state, grads, opt)
        return new_state, {"loss": loss, **opt_metrics}

    return train_step


def make_prefill_step(model: Model, *, pad_to: Optional[int] = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, pad_to=pad_to)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)
    return decode_step
