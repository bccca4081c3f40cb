"""Mixture-of-Experts layer: top-k router and the dense dispatch backend.

Dispatch is the paper's hash-join probe (CoroAMU Table II "HJ"): every token
is a tuple probing the expert "hash table". This module ports the
single-device part of the reference package's ``models/moe.py``: the dense
backend computes every expert for every token and combines the top-k by
masks (exact, dropless). Its expert FFN is three grouped matmuls through
the `kernels/moe_gmm` kernel, which streams each expert's weights through a
ring of shared-memory slots, forward and backward (`moe_gmm.ops`). The expert-parallel backends need a device
mesh; until the port has one, every ``moe_impl`` runs the dense backend, as
the reference does without a mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models.params import ParamSpec

__all__ = ["moe_dense", "moe_layer", "moe_param_specs", "router_topk"]


def moe_param_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    e, dm, dff = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return {
        "router": ParamSpec((dm, e), ("embed", "experts"), init="fan_in"),
        "w_gate": ParamSpec((e, dm, dff), ("experts", "embed", "mlp"),
                            init="fan_in"),
        "w_up": ParamSpec((e, dm, dff), ("experts", "embed", "mlp"),
                          init="fan_in"),
        "w_down": ParamSpec((e, dff, dm), ("experts", "mlp", "embed"),
                            init="fan_in"),
    }


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, d] -> (gates [T, k] in x's type, experts [T, k] int32,
    Switch-style load-balancing aux loss, an f32 scalar)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = w_router.shape[1]
    me = probs.mean(0)
    ce = F.one_hot(experts[:, 0], e).float().mean(0)
    aux = e * torch.sum(me * ce)
    return gates.to(x.dtype), experts.to(torch.int32), aux


def _expert_ffn(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU: xs [E or 1, C, d] -> [E, C, d]. A leading 1 is
    broadcast over the E experts as a stride-0 view, never copied (and its
    gradient summed over them). Each of the three grouped matmuls is the
    `moe_gmm` kernel on CUDA tensors (its plain version on CPU tensors),
    for every shape, forward and backward."""
    dt = xs.dtype
    h = F.silu(moe_gmm(xs, wg.to(dt)))
    h = h * moe_gmm(xs, wu.to(dt))
    return moe_gmm(h, wd.to(dt))


def moe_dense(p, x: torch.Tensor, cfg: ArchConfig):
    """Dense backend: every expert for every token, combined by masks.

    x: [B, S, d] -> (y [B, S, d], aux). Exact dropless combine;
    O(T * E * d * dff) flops."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, experts, aux = router_topk(xt, p["router"], cfg.top_k)
    outs = _expert_ffn(xt[None], p["w_gate"], p["w_up"], p["w_down"])  # [E,T,d]
    comb = F.one_hot(experts.long(), cfg.n_experts).to(xt.dtype) \
        * gates[..., None]                                          # [T,k,E]
    y = torch.einsum("tke,etd->td", comb, outs)
    return y.reshape(b, s, d), aux


def moe_layer(p, x: torch.Tensor, cfg: ArchConfig):
    """The MoE FFN of one layer. Without a device mesh (the only case this
    package has yet) the reference sends every ``moe_impl`` — auto, dense
    and ep — to the dense backend; so does this."""
    return moe_dense(p, x, cfg)
