"""Mixture-of-Experts layer: top-k router and three dispatch backends (the
reference package's ``models/moe.py``).

Dispatch is the paper's hash-join probe (CoroAMU Table II "HJ"): every token
is a tuple probing the expert "hash table". The backends:

  * dense          - every expert for every token, combined by masks
                     (exact, dropless): one device, and the oracle;
  * ep (a2a)       - expert-parallel over a mesh's `model` axis, tokens
                     split by sequence: sort tokens by expert into
                     capacity-bounded buffers, all_to_all to the experts'
                     owners, the local experts' FFN, all_to_all back, a
                     weighted combine;
  * ep (replicated) - expert-parallel for tokens every `model` rank holds
                     (decode, one position): each rank runs its experts
                     over all the tokens, and a sum over `model` combines.

Every expert FFN is three grouped matmuls through the `kernels/moe_gmm`
kernel, which streams each expert's weights through a ring of
shared-memory slots, forward and backward (`moe_gmm.ops`): over every
expert (dense), over this rank's experts' capacity buffers ``[E_l, n C,
d]`` (a2a), or over this rank's experts with one token block shared at
expert stride 0 (replicated). Under a mesh each rank holds only its
``E / n`` experts of ``w_gate``, ``w_up`` and ``w_down`` (`ep_sharded`).

Both expert-parallel backends train: their collectives are differentiable
under `sharding`'s sum convention (the all_to_alls' backward the
all_to_alls back, the all_gather's a reduce-scatter, the all_reduce's
and the aux mean's an all_reduce), so a rank's backward runs K2's d
tokens and d weights over the same buffers: 9 launches a layer a step.
As in the reference, each shard sizes its capacity from its own tokens
and drops by it, and the aux loss is the mean of the shards' terms, so a
mesh's loss is not the single-device loss of a MoE arch.

The paged engine holds its round and chunks whole on every rank
(`moe_layer_whole`): a 32-token chunk ``[1, 32, d]`` takes `moe_ep_a2a`
over `model`, a decode round ``[B, 1, d]`` `moe_ep_replicated`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import NULL_CTX, ShardingCtx, local_shard, \
    shard_map

__all__ = ["EXPERT_SPECS", "ep_sharded", "moe_dense", "moe_ep_a2a",
           "moe_ep_replicated", "moe_layer", "moe_layer_whole",
           "moe_param_specs", "router_logits", "router_topk"]

GMM_F_TILE = 128

# What each rank holds of a MoE layer's weights inside the expert-parallel
# regions (the reference's `_expert_specs`): the experts split over `model`.
EXPERT_SPECS = {
    "router": (),
    "w_gate": ("model",),
    "w_up": ("model",),
    "w_down": ("model",),
}


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


def router_logits(x: torch.Tensor, w_router: torch.Tensor, cfg: ArchConfig,
                  ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """x: [T, d] -> the router's f32 logits [T, E] over every expert. A
    router that holds this rank's block of the experts over `model` (the
    placed layout, column-parallel) gives its block of the logits, and
    they are gathered over `model` before the softmax and the top-k, so
    that the routing and the aux term are the whole router's."""
    logits = x.float() @ w_router.float()
    if w_router.shape[1] != cfg.n_experts:
        logits = ctx.all_gather(logits, "model", dim=-1)
    return logits


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int, *,
                logits: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, d] -> (gates [T, k] in x's type, experts [T, k] int32,
    Switch-style load-balancing aux loss, an f32 scalar). `logits`, when
    given, are x's f32 logits over every expert (`router_logits`)."""
    if logits is None:
        logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = logits.shape[1]
    me = probs.mean(0)
    ce = F.one_hot(experts[:, 0], e).float().mean(0)
    aux = e * torch.sum(me * ce)
    return gates.to(x.dtype), experts.to(torch.int32), aux


def _gmm_eligible(xs, wg, wu, wd) -> bool:
    """Where the reference's expert FFN reaches its Pallas grouped matmul
    on a TPU: matched ``[E, ...]`` batching and output widths that divide
    its 128-wide tile. The port's kernel takes every shape; this says
    where the reference's kernel stands against it."""
    return (xs.ndim == 3 and xs.shape[0] == wg.shape[0]
            and wg.shape[-1] % GMM_F_TILE == 0
            and wd.shape[-1] % GMM_F_TILE == 0)


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


def moe_dense(p, x: torch.Tensor, cfg: ArchConfig,
              ctx: ShardingCtx = NULL_CTX):
    """Dense backend: every expert for every token, combined by masks.

    x: [B, S, d] -> (y [B, S, d], aux). Exact dropless combine;
    O(T * E * d * dff) flops. Experts that hold this rank's block of
    their width over `model` (placed where `model` does not divide the
    experts: column-parallel, then row-parallel) give partial outputs,
    summed over `model`."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, experts, aux = router_topk(
        xt, p["router"], cfg.top_k,
        logits=router_logits(xt, p["router"], cfg, ctx))
    outs = _expert_ffn(xt[None], p["w_gate"], p["w_up"], p["w_down"])  # [E,T,d]
    comb = F.one_hot(experts.long(), cfg.n_experts).to(xt.dtype) \
        * gates[..., None]                                          # [T,k,E]
    y = torch.einsum("tke,etd->td", comb, outs)
    if p["w_down"].shape[1] != cfg.d_ff_expert:
        y = ctx.all_reduce(y, "sum")
    return y.reshape(b, s, d), aux


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (cap + 7) // 8 * 8)


def _dispatch_local(xt: torch.Tensor, gates: torch.Tensor,
                    experts: torch.Tensor, cfg: ArchConfig, capacity: int):
    """Sort-based capacity dispatch: xt [T, d] -> (buf [E, C, d], combine
    meta). The T k assignments are sorted by expert (a stable sort, so the
    first C of each expert, in token order, keep their place, as under
    ``jnp.argsort``); an assignment past its expert's capacity is dropped:
    it adds zeros into its expert's first slot and its weight is 0."""
    t, d = xt.shape
    k, e = cfg.top_k, cfg.n_experts
    dev = xt.device
    flat_e = experts.reshape(-1).long()                    # [T k]
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)             # group by expert
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # position within the expert's group: an inclusive count less the
    # group's first index
    pos_in_e = torch.cumsum(torch.ones_like(se), 0) - 1
    seg_start = torch.searchsorted(se, torch.arange(e, device=dev),
                                   right=False)
    pos_in_e = pos_in_e - seg_start[se]
    keep = pos_in_e < capacity
    slot = se * capacity + torch.where(keep, pos_in_e, 0)
    buf = torch.zeros(e * capacity, d, dtype=xt.dtype, device=dev)
    buf.index_add_(0, slot, torch.where(keep[:, None], xt[st], 0))
    meta = dict(slot=slot, order=order, gate=sg, keep=keep)
    return buf.reshape(e, capacity, d), meta


def _combine_local(buf: torch.Tensor, meta, t: int) -> torch.Tensor:
    """buf [E, C, d] -> y [T, d]: each token's k slots weighted by gate x
    keep, summed in the assignments' order (no scatter-add: the sum is the
    same on every run)."""
    e, c, d = buf.shape
    contrib = buf.reshape(e * c, d)[meta["slot"]] \
        * (meta["gate"] * meta["keep"])[:, None]
    by_token = torch.empty_like(contrib)
    by_token[meta["order"]] = contrib                   # token-major again
    return by_token.reshape(t, -1, d).sum(1)


def _expert_parallel(body, p, x, cfg: ArchConfig, ctx: ShardingCtx,
                     x_spec):
    """`body(p, x)` through `sharding.shard_map` with the reference's
    specs: the experts split over `model` (`EXPERT_SPECS`; a block that
    is not E / n experts of the layer's raises ValueError), the tokens
    `x_spec`, the aux term replicated."""
    whole = {k: (cfg.n_experts,) + (None,) * (p[k].ndim - 1)
             for k, spec in EXPERT_SPECS.items() if spec}
    return shard_map(body, ctx=ctx, in_specs=(EXPERT_SPECS, x_spec),
                     out_specs=(x_spec, ()))(p, x, whole=(whole, None))


def _batch_spec(ctx: ShardingCtx):
    dp = tuple(a for a in ctx.mesh.axis_names if a in ("pod", "data"))
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def moe_ep_a2a(p, x: torch.Tensor, cfg: ArchConfig, ctx: ShardingCtx, *,
               aux: bool = True):
    """Sequence- and expert-parallel backend. x: [B_l, S, d], this rank's
    batch (the same on every rank of `model`); p: the router and this
    rank's E / n experts. Each rank dispatches its S / n positions into
    [E, C, d] capacity buffers, all_to_all sends expert block i to rank i
    and brings in the n ranks' buffers for its experts ([E_l, n C, d]),
    the grouped-matmul kernel runs them, all_to_all sends them back, and
    the combine weighs them; an all_gather over `model` makes the
    activation whole again. Returns (y [B_l, S, d], the router's aux loss
    averaged over every rank, or None without `aux`). A router that holds
    its block of the experts (the placed layout) takes the logits of
    every position, which each rank of `model` holds, gathers them and
    keeps its positions'."""
    return _expert_parallel(lambda p, x: _a2a_body(p, x, cfg, ctx, aux),
                            p, x, cfg, ctx, (_batch_spec(ctx), "model"))


def _a2a_body(p, x: torch.Tensor, cfg: ArchConfig, ctx: ShardingCtx,
              aux: bool):
    n = ctx.axis_sizes["model"]
    e_l = cfg.n_experts // n
    b, s, d = x.shape
    sl = s // n
    r = ctx.index("model")
    xt = x[:, r * sl:(r + 1) * sl].reshape(b * sl, d)
    logits = None
    if p["router"].shape[1] != cfg.n_experts:
        logits = router_logits(x.reshape(b * s, d), p["router"], cfg, ctx)
        logits = logits.reshape(b, s, -1)[:, r * sl:(r + 1) * sl] \
            .reshape(b * sl, -1)
    gates, experts, a = router_topk(xt, p["router"], cfg.top_k, logits=logits)
    buf, meta = _dispatch_local(xt, gates, experts, cfg,
                                _capacity(xt.shape[0], cfg))
    e, c, _ = buf.shape
    recv = ctx.all_to_all(buf.reshape(n, e_l, c, d))
    # recv[src, e_l, c, d]: the capacity blocks of every source rank
    recv = recv.transpose(0, 1).reshape(e_l, n * c, d)
    out = _expert_ffn(recv, p["w_gate"], p["w_up"], p["w_down"])
    out = out.reshape(e_l, n, c, d).transpose(0, 1)
    back = ctx.all_to_all(out)
    y = _combine_local(back.reshape(e, c, d), meta, xt.shape[0])
    y = ctx.all_gather(y.reshape(b, sl, d), "model", dim=1)
    return y, (ctx.mean_all(a) if aux else None)


def moe_ep_replicated(p, x: torch.Tensor, cfg: ArchConfig, ctx: ShardingCtx,
                      *, aux: bool = True):
    """Expert parallelism for tokens every `model` rank holds (decode, one
    position): each rank runs its E / n experts over all of its tokens
    (the grouped-matmul kernel over ``[1, T, d]`` at expert stride 0),
    keeps the assignments to its experts, and a sum over `model` combines
    them. Returns (y [B_l, S, d], aux as `moe_ep_a2a`)."""
    return _expert_parallel(
        lambda p, x: _replicated_body(p, x, cfg, ctx, aux), p, x, cfg, ctx,
        (_batch_spec(ctx),))


def _replicated_body(p, x: torch.Tensor, cfg: ArchConfig, ctx: ShardingCtx,
                     aux: bool):
    n = ctx.axis_sizes["model"]
    e_l = cfg.n_experts // n
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, experts, a = router_topk(
        xt, p["router"], cfg.top_k,
        logits=router_logits(xt, p["router"], cfg, ctx))
    rel = experts - ctx.index("model") * e_l
    local = (rel >= 0) & (rel < e_l)
    outs = _expert_ffn(xt[None], p["w_gate"], p["w_up"], p["w_down"])
    comb = F.one_hot(torch.where(local, rel, 0).long(), e_l).to(xt.dtype)
    comb = comb * (gates * local.to(gates.dtype))[..., None]
    y = ctx.all_reduce(torch.einsum("tke,etd->td", comb, outs), "sum")
    return y.reshape(b, s, d), (ctx.mean_all(a) if aux else None)


def ep_sharded(cfg: ArchConfig, ctx: ShardingCtx) -> bool:
    """Whether `moe_layer` takes the expert-parallel backends, so that each
    rank holds only its experts: a mesh with a `model` axis dividing the
    experts, and ``moe_impl`` auto or ep."""
    n_model = ctx.axis_sizes.get("model", 0) if ctx.mesh is not None else 0
    return bool(cfg.moe and cfg.moe_impl in ("auto", "ep") and ctx.mesh
                is not None and ctx.use_shard_map and n_model
                and cfg.n_experts % n_model == 0)


def moe_layer(p, x: torch.Tensor, cfg: ArchConfig,
              ctx: ShardingCtx = NULL_CTX, *, aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE FFN of one layer, by ``cfg.moe_impl`` as in the reference:
    auto and ep take expert parallelism on a mesh whose `model` axis
    divides the experts (`moe_ep_a2a` when it also divides the sequence,
    else `moe_ep_replicated`), and the dense backend otherwise. Returns
    (y, aux); `aux=False` (serving, which drops it) spares the
    expert-parallel backends their mean over the ranks and gives None."""
    if ep_sharded(cfg, ctx):
        if x.shape[1] % ctx.axis_sizes["model"] == 0:
            return moe_ep_a2a(p, x, cfg, ctx, aux=aux)
        return moe_ep_replicated(p, x, cfg, ctx, aux=aux)
    return moe_dense(p, x, cfg, ctx)


def moe_layer_whole(p, x: torch.Tensor, cfg: ArchConfig,
                    ctx: ShardingCtx) -> torch.Tensor:
    """`moe_layer` (without the aux loss) for a batch that every rank
    holds whole: the paged engine's decode round ``[B, 1, d]`` and prefill
    chunk ``[1, C, d]``, which the reference hands to its ``moe_layer``
    as one global array. Its expert-parallel backends split that batch
    over `data` (the reference's ``_mesh_bspec``), so here each rank takes
    its `data` rows, runs `moe_layer` on them and the rows are gathered
    back over `data`. A batch that `data` does not divide (a 1-row chunk
    on a mesh with ``data > 1``) is refused with a ValueError, as the
    reference's shard_map refuses it, on every rank and before any
    collective. Returns y [B, S, d]."""
    if not ep_sharded(cfg, ctx):
        return moe_dense(p, x, cfg, ctx)[0]
    axes = tuple(a for a in ctx.mesh.axis_names if a in ("pod", "data"))
    n = ctx.axis_size(axes or None)
    if x.shape[0] % n:
        raise ValueError(
            f"expert-parallel MoE on mesh {ctx.axis_sizes} splits the batch "
            f"over {axes}: an activation of shape {tuple(x.shape)} has "
            f"{x.shape[0]} rows for {n} ranks (the reference's shard_map "
            f"refuses it too)")
    spec = (axes if len(axes) > 1 else axes[0],) if n > 1 else ()
    y, _ = moe_layer(p, local_shard(x, spec, ctx), cfg, ctx, aux=False)
    for axis in reversed(axes):
        y = ctx.all_gather(y, axis, dim=0)
    return y
