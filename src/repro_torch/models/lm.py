"""The LM: parameter specs; the training loss (`loss_fn`: next-token
cross-entropy plus the MoE router's aux loss); the dense engine's one-shot
prefill and one-token decode over ``[L, B, S, KH, D]`` caches; and the
paged engine's decode over paged KV pools for a round of ragged requests
and chunked prefill into the pools.

Parameters keep the reference package's tree — names, shapes and the
stacked ``layers`` axis (``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, ...).
The reference scans the layer stack; here a Python loop walks the stacked
axis and each layer writes its cache rows (or its SSM state) into its
slice of the stacked caches or pools in place. The functions still return
the caches, so callers read the same as against the reference.

Families, all on the dense engine: attention LMs with a dense SwiGLU FFN
(yi-6b, granite-3-2b, internlm2-20b, command-r-plus-104b) or a MoE FFN
(granite-moe-1b-a400m, qwen3-moe-30b-a3b; `models/moe.py`, whose expert
matmuls are the `moe_gmm` kernel), both also on the paged engine; the
Mamba-2 SSM family (mamba2-130m; `models/ssm.py`, whose prefill scan is
the `ssd_scan` kernel); the hybrid family (hymba-1.5b: attention beside
SSM heads in every layer, sliding-window attention over a ring cache);
the encoder-decoder family (whisper-medium: a non-causal encoder over
frame embeddings, a decoder with cross-attention over its output); and
the VLM family (paligemma-3b: patch embeddings as a bidirectional prefix
of the text). Dense decode attention, over a cache, a ring or the
encoder's output, is the `flash_decode` kernel; paged decode attention
the `paged_decode` kernel.

On a device mesh (a `sharding.ShardingCtx` with a running mesh, one process
a rank) the dense engine's functions take this rank's slice of the batch
(its `data` coordinate's) and the same weights on every rank but a MoE
layer's experts, of which each rank holds its `model` coordinate's share
(`params.local_params`). The MoE FFN is expert-parallel (`models/moe.py`);
the decode caches are split by sequence over `model` where the reference
splits them (`cache_specs`: ``kv_seq``), each rank holding its
``[L, B/data, S/model, KH, D]`` slice, and decode attention merges the
shards' flash-decode results (`common.flash_decode_attention`). The cache
then also records the whole caches' lengths (``cache["kv_len"]``), which
the shards alone do not tell. The paged engine's steps hold their round
or chunk, and the KV pools, whole on every rank, as the reference does:
there `ctx` reaches only the MoE layers (`_paged_ffn`) and the
unembedding.

The dense engine's functions and the loss also take the placed layout,
the reference's placed steps (`runtime.steps.jit_prefill_step`,
`jit_decode_step`, and the train step on a mesh): every parameter placed
by its rules (`Model.place`) and every cache leaf by ``cache_specs``
(`place_caches`). One code path serves both layouts: each op decides from
the leaf it is handed. Each layer's leaves are gathered at the start of
the layer, inside its remat, over the axes no op computes in parallel
(`_gathered`: ``data``, and a ``model`` split outside `PARALLEL_AXES`,
as the SSM's), which on the held layout gathers nothing; in grad mode the
gather's backward reduce-scatters the gradients into the rank's blocks
(`sharding.gather_blocks`). Attention is column-parallel over the heads
`wq`/`wk`/`wv` hold and row-parallel through `wo` (one sum over `model`),
the MLP likewise, the embedding and the logits vocab-parallel (the loss
too: `_xent_split`), the MoE router's logits gathered, and a cache held by
heads (a ring, or a sequence `model` does not divide) attended by the
rank's heads.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSuite, cache_seq_len
from repro_torch.core import tree
from repro_torch.models.common import (
    apply_rope,
    attention,
    decode_attention,
    embed_lookup,
    paged_cache_append,
    paged_cache_append_chunk,
    paged_decode_attention,
    paged_prefill_attention,
    rms_norm,
    sinusoid_pos_emb,
    swiglu,
)
from repro_torch.kernels.decode_attention.decode_attention import flash_decode
from repro_torch.kernels.moe_gmm.ops import saving_products
from repro_torch.models.moe import moe_layer, moe_layer_whole, moe_param_specs
from repro_torch.models.params import (ParamSpec, held_specs, map_specs,
                                       torch_dtype)
from repro_torch.models.ssm import (
    ssm_cache_shape,
    ssm_decode,
    ssm_dims,
    ssm_forward,
    ssm_param_specs,
)
from repro_torch.sharding import (NULL_CTX, ShardingCtx, block_shape,
                                  gather_blocks, local_shard)

# ------------------------------------------------------------- param specs


def _attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    s: Dict[str, ParamSpec] = {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": ParamSpec((d, kh, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": ParamSpec((d, kh, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.use_bias:
        s["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = ParamSpec((kh, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = ParamSpec((kh, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    return s


def _mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": ParamSpec((d,), ("embed",), init="ones"),
        "w_gate": ParamSpec((d, f), ("embed", "mlp"), init="fan_in"),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), init="fan_in"),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), init="fan_in"),
    }


def _layer_specs(cfg: ArchConfig, *, cross: bool = False) -> Dict[str, Any]:
    """One layer: an SSM block (the SSM family), or attention (beside SSM
    heads for the hybrid family, followed by cross-attention in an
    enc-dec decoder) and the FFN. An encoder layer is the plain form."""
    if cfg.family == "ssm":
        return {"ssm_ln": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "ssm": ssm_param_specs(cfg)}
    s: Dict[str, Any] = {"attn": _attn_specs(cfg)}
    if cfg.hybrid:
        s["ssm"] = ssm_param_specs(cfg)
    if cross:
        s["cross"] = _attn_specs(cfg)
    if cfg.moe:
        s["moe"] = moe_param_specs(cfg)
        s["moe_ln"] = ParamSpec((cfg.d_model,), ("embed",), init="ones")
    else:
        s["mlp"] = _mlp_specs(cfg)
    return s


def _stack(tree, n: int):
    return map_specs(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype,
                            s.init, s.scale),
        tree)


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree of any shipped arch, in the reference's names and
    shapes: the encoder stack, its norm and the decoder's learned
    positions (``dec_pos_embed [32768 // dec_ratio, d]``) for an enc-dec
    arch, the patch projection for a VLM."""
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "layers": _stack(_layer_specs(cfg, cross=cfg.enc_dec), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    if cfg.enc_dec:
        specs["enc_layers"] = _stack(_layer_specs(cfg), cfg.n_enc_layers)
        specs["enc_norm"] = ParamSpec((d,), ("embed",), init="ones")
        specs["dec_pos_embed"] = ParamSpec((32768 // cfg.dec_ratio, d),
                                           ("seq", "embed"))
    if cfg.vlm:
        specs["patch_proj"] = ParamSpec((d, d), ("embed", None),
                                        init="fan_in")
    return map_specs(
        lambda s: ParamSpec(s.shape, s.axes, cfg.param_dtype, s.init, s.scale),
        specs)


# ------------------------------------------------------ the leaves an op uses

# The logical axes whose split over `model` the ops compute with in
# parallel: attention's heads (column-parallel, then `wo` row-parallel),
# the MLP's width (likewise), the vocabulary (the embedding's rows, the
# logits' columns) and the experts (expert-parallel). A leaf's split of any
# other axis, or over any other mesh axis (`data`, `pod`), is gathered
# just before the leaf is used, and freed after.
PARALLEL_AXES = frozenset({"heads", "kv_heads", "mlp", "vocab", "experts"})


def _strip(entries) -> tuple:
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _plan(spec_tree, ctx: ShardingCtx):
    """Each leaf of a spec tree (one layer's, or one leaf) with its placed
    spec, in the leaves' order; None without a mesh."""
    if ctx.mesh is None:
        return None
    return [(s, ctx.spec(s.axes, s.shape)) for s in tree.leaves(spec_tree)]


def _gathered(node, plan, ctx: ShardingCtx):
    """This rank's leaves of `node` (one layer's tree, or one leaf) -> the
    blocks its ops compute with: each leaf gathered over the mesh axes it
    is split over but no op computes in parallel (all but `model` splits
    of `PARALLEL_AXES`). Every op decides from the leaf it is handed: the
    split a leaf is held with is read from its shape against its placed
    spec's (`plan`), so the held layout (every leaf whole but the experts)
    gathers nothing, and the placed layout (`Model.place`) gathers its
    `data` blocks. One all_gather a group of leaves
    (`sharding.gather_blocks`)."""
    if plan is None:
        return node
    leaves = tree.leaves(node)
    fine, coarse = [], []
    for x, (s, placed) in zip(leaves, plan):
        held = _strip(e if e is not None and x.shape[d] != s.shape[d]
                      else None for d, e in enumerate(placed))
        fine.append(held)
        coarse.append(_strip(e if e == "model" and s.axes[d] in PARALLEL_AXES
                             else None for d, e in enumerate(held)))
    if fine == coarse:
        return node
    return tree.unflatten(node, gather_blocks(leaves, fine, coarse, ctx))


def _top(params, key: str, cfg: ArchConfig, ctx: ShardingCtx):
    """Top-level leaf `key` as its op uses it (`_gathered`); None where the
    arch has none."""
    x = params.get(key)
    if x is None or ctx.mesh is None:
        return x
    return _gathered(x, _plan(param_specs(cfg)[key], ctx), ctx)


# ---------------------------------------------------------------- attention


def _proj(h, w, bias=None):
    """[B, S, d] x [d, heads, hd] -> [B, S, heads, hd] in h's type."""
    b, s, d = h.shape
    out = (h @ w.to(h.dtype).reshape(d, -1)).reshape(b, s, w.shape[1],
                                                     w.shape[2])
    return out if bias is None else out + bias.to(h.dtype)


def _project_qkv(p, h):
    return (_proj(h, p["wq"], p.get("bq")), _proj(h, p["wk"], p.get("bk")),
            _proj(h, p["wv"], p.get("bv")))


def _heads(x, n_whole: int, split: bool, ctx: ShardingCtx):
    """x [B, S, h, D], holding every one of `n_whole` heads or this rank's
    block of them over `model` -> the layout `split` asks for: the rank's
    block cut out of every head (no collective), or every head gathered
    over `model`."""
    local = x.shape[2] != n_whole
    if split and not local:
        n = n_whole // ctx.axis_sizes["model"]
        return x.narrow(2, ctx.index("model") * n, n)
    if local and not split:
        return ctx.all_gather(x, "model", dim=2)
    return x


def _kv_span(hl: int, cfg: ArchConfig, ctx: ShardingCtx):
    """(first, count): the K/V heads that this rank's block of `hl` q heads
    over `model` reads."""
    g = cfg.n_heads // cfg.kv_heads
    first = ctx.index("model") * hl
    return first // g, (first + hl - 1) // g - first // g + 1


def _kv_for(q, kv, cfg: ArchConfig, ctx: ShardingCtx):
    """The K or V heads that q's heads read, grouped as `attention` reads
    them: every head for every q head; for a block of q heads over `model`,
    from every K/V head or from the span of them the block reads
    (`_kv_span`: this rank's block of K/V heads where `wk` holds one, or
    the span `_kv_weights` cut), the K/V heads its groups read (the kv
    itself or a slice where the block holds whole groups, else each q
    head's own)."""
    h, kh = cfg.n_heads, cfg.kv_heads
    if q.shape[2] == h:
        return _heads(kv, kh, False, ctx)
    hl, g = q.shape[2], h // kh
    first = ctx.index("model") * hl
    lo, n = _kv_span(hl, cfg, ctx)
    if kv.shape[2] == kh:
        kv = kv.narrow(2, lo, n)
    elif kv.shape[2] != n:
        raise ValueError(f"a rank's {hl} q heads do not read the groups of "
                         f"its {kv.shape[2]} K/V heads (h {h}, kh {kh})")
    if n == 1 or (hl == g * n and first % g == 0):
        return kv
    idx = (first + torch.arange(hl, device=kv.device)) // g - lo
    return kv.index_select(2, idx)


def _kv_weights(p, hl: int, cfg: ArchConfig, ctx: ShardingCtx):
    """Attention weights `p` whose `wk`/`wv` hold every K/V head (the
    guard keeps them whole where `model` does not divide the K/V heads)
    cut to the span that this rank's block of `hl` q heads reads
    (`_kv_span`), so that only those heads are projected; `p` itself
    where `wq` holds every head or `wk` a block."""
    if hl == cfg.n_heads or p["wk"].shape[1] != cfg.kv_heads:
        return p
    lo, n = _kv_span(hl, cfg, ctx)
    out = dict(p, wk=p["wk"].narrow(1, lo, n), wv=p["wv"].narrow(1, lo, n))
    for key in ("bk", "bv"):
        if key in p:
            out[key] = p[key].narrow(0, lo, n)
    return out


def _attn_out(p, o, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """The output projection of o [B, S, heads, hd]: row-parallel when `wo`
    holds this rank's block of the heads (o brought to that block, the
    partial products summed over `model`), then the bias, once."""
    wo = p["wo"]
    split = wo.shape[0] != cfg.n_heads
    o = _heads(o, cfg.n_heads, split, ctx)
    b, s, h, hd = o.shape
    out = o.reshape(b, s, h * hd) @ wo.to(o.dtype).reshape(h * hd, -1)
    if split:
        out = ctx.all_reduce(out, "sum")
    if "bo" in p:
        out = out + p["bo"].to(o.dtype)
    return out


def _ffn(p, x, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX, *,
         aux: bool = True):
    """The post-attention half of a block (MoE or SwiGLU MLP), on this
    rank's rows of the batch. Returns (x, aux): the MoE router's
    load-balancing aux loss (an f32 scalar; None for the MLP, and on a mesh
    without `aux`), which the loss adds and the serving paths ignore. An
    MLP whose weights hold this rank's block of its width (the placed
    layout) is column-parallel, then row-parallel: its partial outputs
    are summed over `model`."""
    if cfg.moe:
        h = rms_norm(x, p["moe_ln"], cfg.norm_eps)
        moe_o, a = moe_layer(p["moe"], h, cfg, ctx, aux=aux)
        return x + moe_o, a
    m = p["mlp"]
    h = rms_norm(x, m["ln"], cfg.norm_eps)
    out = swiglu(h, m["w_gate"].to(h.dtype), m["w_up"].to(h.dtype),
                 m["w_down"].to(h.dtype))
    if m["w_down"].shape[0] != cfg.d_ff:
        out = ctx.all_reduce(out, "sum")
    return x + out, None


def _layer(layers, i: int):
    """Layer `i`'s parameters: the i-th slice of every stacked leaf."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _unstack(layers):
    """Every layer's parameters at once: each stacked leaf unbound along
    its layers axis (views, as `_layer`'s slices are). Under autograd the
    backward stacks the layers' gradients once, where `_layer`'s slices
    would each add theirs into a zeroed copy of the whole stacked leaf."""
    if not isinstance(layers, dict):
        return layers.unbind(0)
    parts = {k: _unstack(v) for k, v in layers.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _unembed(params, x, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX, *,
             whole: bool = True):
    """f32 logits of x [B, S, d], under the reference's constraint of
    them to ``("batch", "seq", "vocab")`` (`ShardingCtx.constrain`: no
    collective, each rank already holds its rows). A table that holds
    this rank's block of the vocabulary (the placed layout; tied or
    ``lm_head``) gives the logits of its block, gathered over `model`
    along the vocabulary when `whole` (the loss takes them split:
    `_xent_split`)."""
    dt = x.dtype
    table = _top(params, "lm_head", cfg, ctx)
    if table is None:
        logits = x @ _top(params, "embed", cfg, ctx).to(dt).T
    else:
        logits = x @ table.to(dt)
    if whole and logits.shape[-1] != cfg.vocab:
        logits = ctx.all_gather(logits, "model", dim=-1)
    return ctx.constrain(logits.float(), ("batch", "seq", "vocab"))


# ------------------------------------------------ dense prefill and decode


def attn_full(p, x, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX, *,
              positions, causal=True, prefix=0, rope=True, kv_all=True):
    """Full-sequence self-attention block (prefill, or the encoder with
    `causal` and `rope` off; the first `prefix` positions of a VLM prompt
    attend both ways), on the heads the weights hold: this rank's block
    of them when `wq` holds one (the placed layout). Returns (attn_out,
    (k, v)) with the (roped) keys and the values, for the cache, in the
    heads `wk` and `wv` hold; without `kv_all` (no cache: the loss) a
    block of q heads over whole `wk`/`wv` projects only the K/V heads it
    reads (`_kv_weights`), and (k, v) hold those."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p if kv_all else _kv_weights(
        p, p["wq"].shape[1], cfg, ctx), h)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, _kv_for(q, k, cfg, ctx), _kv_for(q, v, cfg, ctx),
                  q_pos=positions, k_pos=positions, causal=causal,
                  window=cfg.sliding_window, prefix=prefix,
                  impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return _attn_out(p, o, cfg, ctx), (k, v)


def attn_cross_full(p, x, enc_out, cfg: ArchConfig,
                    ctx: ShardingCtx = NULL_CTX):
    """Cross-attention of the decoder's positions over the encoder's
    output (no mask, no rope), on the heads the weights hold, as
    `attn_full`. Returns (attn_out, (k, v)): the encoder's keys and
    values, the decode steps' static cross cache."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = _proj(h, p["wq"], p.get("bq"))
    enc_out = enc_out.to(h.dtype)
    k = _proj(enc_out, p["wk"], p.get("bk"))
    v = _proj(enc_out, p["wv"], p.get("bv"))
    sq, sk = x.shape[1], enc_out.shape[1]
    o = attention(q, _kv_for(q, k, cfg, ctx), _kv_for(q, v, cfg, ctx),
                  q_pos=torch.arange(sq, device=x.device),
                  k_pos=torch.arange(sk, device=x.device), causal=False,
                  impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return _attn_out(p, o, cfg, ctx), (k, v)


def ring_decode_attention(q, k_cache, v_cache, new_k, new_v, pos,
                          window: int):
    """Sliding-window ring-buffer decode (cache slot = position % window):
    the new K/V row lands at slot ``pos % window`` in place, then every
    live slot is attended. The reference masks slot s live when
    ``pos - (pos - s) % window >= 0``: every slot s <= pos while pos <
    window, every slot after. Softmax does not depend on the keys' order,
    so this is the flash-decode kernel over the whole ring at
    ``min(pos, window - 1)``. `pos` (a 0-d int32 tensor or an int) is
    never read on the host: the slot and the clamp are computed on the
    device, so the step replays in a CUDA graph.

    q: [B, 1, H, D]; k_cache/v_cache: [B, window, KH, D]; new_k/new_v:
    [B, 1, KH, D]. Returns (out [B, 1, H, D], k_cache, v_cache)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_cache.device)
    slot = (pos % window).reshape(1).long()
    k_cache.index_copy_(1, slot, new_k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, new_v.to(v_cache.dtype))
    last = torch.clamp(pos, max=window - 1)
    out = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, last)
    return out[:, None], k_cache, v_cache


def attn_decode(p, x, cache, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX, *,
                pos, cross=False, rope=True, s_total=None):
    """One-token attention against a dense KV cache: self-attention writes
    the new row at `pos` (a 0-d int32 tensor on x's device) in place, into
    a ring when the arch's window covers the cache; cross-attention reads
    the encoder's static K/V, all of it, and writes nothing. Each runs
    the flash-decode kernel; on a mesh `s_total` is the whole cache's
    length (`common.flash_decode_attention`). The cache decides the heads:
    one that holds this rank's block of the K/V heads (the placed layout
    where `model` does not split its sequence; a ring) is attended by the
    rank's q heads with no gather; any other by every q head (gathered
    over `model` when `wq` holds a block: a cache split by sequence takes
    q and the new row with every head, as the reference's shard_map
    does), the result cut back to `wo`'s block. Returns (attn_out,
    (k_cache, v_cache))."""
    kc, vc = cache
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    split = kc.shape[2] != cfg.kv_heads
    q = _heads(_proj(h, p["wq"], p.get("bq")), cfg.n_heads, split, ctx)
    if cross:
        last = (kc.shape[1] if s_total is None else s_total) - 1
        o, _, _ = decode_attention(ctx, q, kc, vc, None, None, last,
                                   update=False, s_total=s_total)
        return _attn_out(p, o, cfg, ctx), (kc, vc)
    k = _heads(_proj(h, p["wk"], p.get("bk")), cfg.kv_heads, split, ctx)
    v = _heads(_proj(h, p["wv"], p.get("bv")), cfg.kv_heads, split, ctx)
    if rope:
        posv = torch.as_tensor(pos, device=x.device).reshape(1)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
    if _is_ring(cfg, kc.shape[1]):
        o, kc, vc = ring_decode_attention(q, kc, vc, k, v, pos, kc.shape[1])
    else:
        o, kc, vc = decode_attention(ctx, q, kc, vc, k, v, pos,
                                     update_mode=cfg.cache_update,
                                     s_total=s_total)
    return _attn_out(p, o, cfg, ctx), (kc, vc)


def _is_ring(cfg: ArchConfig, s_kv: int) -> bool:
    """Whether a self-attention cache of `s_kv` rows is a sliding-window
    ring (never split over a mesh: its axis is ``seq``)."""
    return bool(cfg.sliding_window and s_kv <= cfg.sliding_window)


def _ring_layout(kv, window: int):
    """A prompt's K or V [B, S, KH, D] in a `window`-slot ring (slot =
    position % window): the last `window` rows, rolled by S % window."""
    s_full = kv.shape[1]
    if not window or s_full < window:
        return kv
    kv = kv[:, -window:]
    shift = s_full % window
    return torch.roll(kv, shift, dims=1) if shift else kv


def block_full(p, x, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX, *,
               positions, causal=True, prefix=0, rope=True, cross_src=None,
               build_cache=False):
    """One layer, full sequence. Returns (x, aux, cache_entry): the MoE
    router's aux loss (an f32 scalar; None without MoE, and for a prefill
    (`build_cache`) on a mesh, which drops it); with `build_cache`,
    K/V of an attention layer (in a ring under a sliding window), the
    final SSM and conv states of an SSM or hybrid layer, and the cross K/V
    over `cross_src`; nothing otherwise."""
    if cfg.family == "ssm":
        h = rms_norm(x, p["ssm_ln"], cfg.norm_eps)
        if build_cache:
            out, h_fin, conv = ssm_forward(p["ssm"], h, cfg, return_state=True)
            return x + out, None, {"h": h_fin, "conv": conv}
        return x + ssm_forward(p["ssm"], h, cfg), None, {}
    cache: Dict[str, Any] = {}
    attn_o, (k, v) = attn_full(p["attn"], x, cfg, ctx, positions=positions,
                               causal=causal, prefix=prefix, rope=rope,
                               kv_all=build_cache)
    if cfg.hybrid:
        h = rms_norm(x, p["attn"]["ln"], cfg.norm_eps)
        if build_cache:
            ssm_o, cache["h"], cache["conv"] = ssm_forward(
                p["ssm"], h, cfg, return_state=True)
        else:
            ssm_o = ssm_forward(p["ssm"], h, cfg)
        x = x + 0.5 * (attn_o + ssm_o)
    else:
        x = x + attn_o
    if build_cache:
        cache["k"] = _ring_layout(k, cfg.sliding_window)
        cache["v"] = _ring_layout(v, cfg.sliding_window)
    if cross_src is not None:
        cross_o, (ck, cv) = attn_cross_full(p["cross"], x, cross_src, cfg,
                                            ctx)
        if build_cache:
            cache["cross_k"], cache["cross_v"] = ck, cv
        x = x + cross_o
    x, aux = _ffn(p, x, cfg, ctx, aux=not build_cache)
    return x, aux, cache


def block_decode(p, x, layer_cache, cfg: ArchConfig,
                 ctx: ShardingCtx = NULL_CTX, *, pos, kv_len=None):
    """One layer, one token. Returns (x, new_layer_cache); the attention
    cache is updated in place (the same tensors come back), the SSM state
    of an SSM or hybrid layer is new, the cross cache is read only.
    `kv_len` (on a mesh) holds the whole caches' lengths."""
    kv_len = kv_len or {}
    if cfg.family == "ssm":
        h = rms_norm(x, p["ssm_ln"], cfg.norm_eps)
        out, st = _ssm_step(p["ssm"], layer_cache, h, cfg, ctx)
        return x + out, st
    attn_o, (kc, vc) = attn_decode(p["attn"], x,
                                   (layer_cache["k"], layer_cache["v"]), cfg,
                                   ctx, pos=pos, rope=not cfg.enc_dec,
                                   s_total=kv_len.get("k"))
    new: Dict[str, Any] = {"k": kc, "v": vc}
    if cfg.hybrid:
        h = rms_norm(x, p["attn"]["ln"], cfg.norm_eps)
        ssm_o, st = _ssm_step(p["ssm"], layer_cache, h, cfg, ctx)
        new.update(st)
        x = x + 0.5 * (attn_o + ssm_o)
    else:
        x = x + attn_o
    if "cross" in p:
        cross_o, _ = attn_decode(p["cross"], x, (layer_cache["cross_k"],
                                                 layer_cache["cross_v"]),
                                 cfg, ctx, pos=pos, cross=True,
                                 s_total=kv_len.get("cross_k"))
        x = x + cross_o
    x, _ = _ffn(p, x, cfg, ctx, aux=False)
    return x, new


def _ssm_step(p, layer_cache, h, cfg: ArchConfig, ctx: ShardingCtx):
    """`ssm_decode` on a layer's SSM state. A conv window held as this
    rank's block of ``conv_dim`` (the placed layout) is gathered over
    `model` for the step, and the new window cut back to the block."""
    conv = layer_cache["conv"]
    split = conv.shape[-1] != ssm_dims(cfg)["conv_dim"]
    if split:
        conv = ctx.all_gather(conv, "model", dim=-1)
    out, st = ssm_decode(p, {"h": layer_cache["h"], "conv": conv}, h, cfg)
    if split:
        n = layer_cache["conv"].shape[-1]
        st["conv"] = st["conv"].narrow(-1, ctx.index("model") * n, n)
    return out, st


def _saves_dots(func) -> bool:
    """The ``"dots"`` remat policy's saved ops: the matmuls (the
    reference's ``dots_with_no_batch_dims_saveable``; K2's grouped
    product keeps its own output, `moe_gmm.ops.saving_products`)."""
    return func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default)


def _dots_contexts():
    """The selective-checkpoint contexts of the ``"dots"`` policy: matmul
    outputs saved in the forward and handed back in the recompute, every
    other op recomputed."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if _saves_dots(func)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    fwd, rec = create_selective_checkpoint_contexts(policy)
    store, replay = saving_products()
    return _both(fwd, store), _both(rec, replay)


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _rematted(body, cfg: ArchConfig):
    """`body` under the reference's ``jax.checkpoint`` of a layer
    (``cfg.remat``): in grad mode each call keeps only its inputs and
    recomputes the rest in the backward (`torch.utils.checkpoint`,
    non-reentrant, the RNG state not stashed: no layer draws random
    numbers, and a CUDA graph capture cannot read it); under
    ``remat_policy="dots"`` the matmuls' outputs are kept. Outside grad
    mode (serving, prefill) `body` itself."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body
    from torch.utils.checkpoint import checkpoint

    kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" else {}

    def run(*args, **kwargs):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw, **kwargs)

    return run


def run_layers_full(layers, x, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX,
                    *, positions, causal=True, prefix=0, rope=True,
                    cross_src=None, build_cache=False):
    """Apply every layer of a stack (the decoder's, or the encoder's) in a
    Python loop over its stacked axis, each under the reference's remat
    (`_rematted`). Returns (x, aux_sum, stacked_cache) with the layers'
    aux losses summed in f32 and each cache leaf stacked to [L, ...].
    Each layer's leaves are gathered to the blocks its ops compute with
    (`_gathered`) at the start of its body, inside the remat: the
    checkpoint keeps only the rank's blocks and x, the gathered leaves are
    freed after the layer and gathered again in its recompute, and in grad
    mode the gather's backward reduce-scatters their gradients into the
    rank's blocks."""

    plan = _plan(_layer_specs(cfg, cross=cross_src is not None), ctx)

    def body(lp, x):
        return block_full(_gathered(lp, plan, ctx), x, cfg, ctx,
                          positions=positions, causal=causal, prefix=prefix,
                          rope=rope, cross_src=cross_src,
                          build_cache=build_cache)

    body = _rematted(body, cfg)
    entries = []
    aux = None
    for lp in _unstack(layers):
        x, a, cache = body(lp, x)
        if a is not None:
            aux = a if aux is None else aux + a
        entries.append(cache)
    caches = {k: torch.stack([e[k] for e in entries])
              for k in entries[0]} if entries and entries[0] else {}
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, caches


def run_layers_decode(layers, caches, x, cfg: ArchConfig,
                      ctx: ShardingCtx = NULL_CTX, *, pos, kv_len=None):
    """All layers for one token. Layer i updates its slice of every stacked
    cache leaf ([L, B, S, KH, D] K/V rows, [L, B, H, P, N] SSM state, ...)
    in place; no leaf is re-stacked. Each layer's leaves are gathered
    just before it to the blocks its ops compute with (`_gathered`).
    Returns (x, caches)."""
    plan = _plan(_layer_specs(cfg, cross=cfg.enc_dec), ctx)
    for i in range(cfg.n_layers):
        lc = _layer(caches, i)
        x, nc = block_decode(_gathered(_layer(layers, i), plan, ctx), x, lc,
                             cfg, ctx, pos=pos, kv_len=kv_len)
        for key, new in nc.items():
            if new is not lc[key]:
                lc[key].copy_(new)
    return x, caches


def _vlm_scale(cfg: ArchConfig) -> float:
    """The VLM's embedding scale, sqrt(d_model), rounded to the compute
    type, as the reference multiplies by a scalar of that type."""
    return float(torch.tensor(cfg.d_model ** 0.5,
                              dtype=torch_dtype(cfg.dtype)))


def _embed_tokens(params, tokens, cfg: ArchConfig, ctx: ShardingCtx):
    """The tokens' embeddings in the compute type (vocab-parallel where the
    table holds a block of the vocabulary: `common.embed_lookup`)."""
    return embed_lookup(_top(params, "embed", cfg, ctx), tokens, ctx,
                        cfg.vocab, torch_dtype(cfg.dtype))


def _embed_in(params, batch, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """Token embedding, after the VLM's projected patches (its text scaled
    by sqrt(d_model)). Returns (x, positions)."""
    dt = torch_dtype(cfg.dtype)
    x = _embed_tokens(params, batch["tokens"], cfg, ctx)
    if cfg.vlm:
        x = x * _vlm_scale(cfg)
        patches = batch["patches"].to(dt) @ \
            _top(params, "patch_proj", cfg, ctx).to(dt)
        x = torch.cat([patches, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _encode(params, frames, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """The enc-dec encoder over frame embeddings [B, S_enc, d]: sinusoidal
    positions, non-causal self-attention without rope, the final norm."""
    dt = torch_dtype(cfg.dtype)
    frames = frames.to(dt)
    s = frames.shape[1]
    x = frames + sinusoid_pos_emb(s, cfg.d_model, dt, frames.device)[None]
    x, _, _ = run_layers_full(params["enc_layers"], x, cfg, ctx,
                              positions=torch.arange(s, device=x.device),
                              causal=False, rope=False)
    return rms_norm(x, _top(params, "enc_norm", cfg, ctx), cfg.norm_eps)


def _pad_cache_seq(layer_caches, cfg: ArchConfig, pad_to: Optional[int]):
    """Pad the attention caches along seq so decode can write past the
    prompt; a ring (sliding window) only up to its window."""
    out = dict(layer_caches)
    for key in ("k", "v"):
        if key not in out:
            continue
        kv = out[key]  # [L, B, S, KH, D]
        target = pad_to
        if cfg.sliding_window:
            target = (min(cfg.sliding_window, pad_to) if pad_to
                      else cfg.sliding_window)
        if target and kv.shape[2] < target:
            out[key] = F.pad(kv, (0, 0, 0, 0, 0, target - kv.shape[2]))
    return out


def _trunk(params, batch, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX, *,
           build_cache: bool):
    """The decoder's stack over a whole batch: the encoder first for an
    enc-dec arch (its output is the cross-attention's source), the
    projected patches as a bidirectional prefix for a VLM. Returns (x,
    aux_sum, stacked layer caches, the prefix's length)."""
    if cfg.enc_dec:
        enc_out = _encode(params, batch["frames"], cfg, ctx)
        x = _embed_tokens(params, batch["tokens"], cfg, ctx)
        pos_embed = _top(params, "dec_pos_embed", cfg, ctx)
        x = x + pos_embed[: x.shape[1]].to(x.dtype)[None]
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux, caches = run_layers_full(params["layers"], x, cfg, ctx,
                                         positions=positions, rope=False,
                                         cross_src=enc_out,
                                         build_cache=build_cache)
        return x, aux, caches, 0
    x, positions = _embed_in(params, batch, cfg, ctx)
    prefix = x.shape[1] - batch["tokens"].shape[1] if cfg.vlm else 0
    x, aux, caches = run_layers_full(params["layers"], x, cfg, ctx,
                                     positions=positions, prefix=prefix,
                                     build_cache=build_cache)
    return x, aux, caches, prefix


_KV_KEYS = ("k", "v", "cross_k", "cross_v")


def _placed_layout(params, cfg: ArchConfig, ctx: ShardingCtx) -> bool:
    """Whether `params` are this rank's blocks placed by their rules
    (`Model.place`) rather than held as serving holds them (every leaf
    whole but the experts: `params.held_specs`), read from the leaves'
    shapes. A tree whose every leaf has the same block in both layouts
    counts as held."""
    specs = param_specs(cfg)
    held = dict(tree.paths(held_specs(specs, cfg, ctx)))
    spec = dict(tree.paths(specs))
    return any(tuple(x.shape) != block_shape(spec[path].shape, held[path], ctx)
               for path, x in tree.paths(params))


def _hold_caches(layers, params, cfg: ArchConfig, ctx: ShardingCtx):
    """Whole stacked caches of this rank's rows -> the blocks it holds (a
    copy of its block of each split one), in the layout of `params`
    (`_placed_layout`), and the whole K/V caches' lengths. K/V computed on
    this rank's block of the heads (placed weights) are first gathered
    over `model` to every head. The held layout (serving's): a
    self-attention cache (not a ring) and the cross cache split by
    sequence over `model` when it divides them, the reference's
    ``kv_seq`` layout, every other leaf whole. The placed layout (the
    reference's ``cache_shardings``, `place_caches`): every leaf by its
    logical axes (`cache_specs`) through the rules and their guard."""
    kv_len = {key: layers[key].shape[2] for key in ("k", "cross_k")
              if key in layers}
    heads = [key for key in _KV_KEYS
             if key in layers and layers[key].shape[3] != cfg.kv_heads]
    if heads:
        whole = gather_blocks([layers[key] for key in heads],
                              [(None, None, None, "model")] * len(heads),
                              [()] * len(heads), ctx)
        layers = dict(layers, **dict(zip(heads, whole)))
    if _placed_layout(params, cfg, ctx):
        return place_caches(layers, cfg, ctx, rows=True), kv_len
    held = dict(layers)
    for key in _KV_KEYS:
        if key not in layers:
            continue
        s_kv = layers[key].shape[2]
        if key in ("k", "v") and _is_ring(cfg, s_kv):
            continue
        spec = ctx.spec((None, None, "kv_seq"), (None, None, s_kv))
        if spec:
            held[key] = local_shard(layers[key], spec, ctx).clone()
    return held, kv_len


def place_caches(layers, cfg: ArchConfig, ctx: ShardingCtx, *,
                 rows: bool = False):
    """Whole stacked caches (``cache["layers"]``) -> this rank's blocks of
    them placed as the reference's ``cache_shardings`` places them: each
    leaf by its logical axes (`cache_specs`) through the rules and their
    guard, K/V by sequence over `model` where it divides them, else by
    heads where `model` divides those (a ring, whose axis is ``seq``, by
    heads), the SSM conv window by ``conv_dim``, the SSM state by rows
    alone. With `rows` the caches are already this rank's rows (a
    prefill's of the rank's batch), and only the other axes are cut. A
    split leaf is a copy of the rank's block; a whole one is the same
    tensor."""
    out = {}
    for key, leaf in layers.items():
        axes = _cache_axes(cfg, leaf.shape[2])[key]
        if rows:
            axes = tuple(None if a == "batch" else a for a in axes)
        spec = ctx.spec(axes, leaf.shape)
        out[key] = local_shard(leaf, spec, ctx).clone() if spec else leaf
    return out


def prefill(params, batch, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX,
            pad_to: Optional[int] = None):
    """Build decode state from a full prompt. batch["tokens"]: [B, S] text
    tokens, with batch["frames"] [B, S_enc, d] for an enc-dec arch (the
    encoder's input) or batch["patches"] [B, P, d] for a VLM (a prefix of
    P positions before the text). `pad_to` counts text positions.
    Returns (cache, last_logits [B, 1, V] f32); cache = {"pos": the
    decoder's length (a 0-d int32 tensor on the tokens' device, as the
    reference's is), "layers": stacked per-layer caches, K/V padded to
    `pad_to` rows (plus the prefix), a ring to its window}. On a mesh the
    batch is this rank's, the caches are this rank's shards, and
    ``cache["kv_len"]`` holds the whole K/V caches' lengths. The
    parameters may be held or placed (`Model.place`): each op reads their
    layout from their shapes, and the caches come out in the same layout
    (`_hold_caches`): held as serving holds them, or placed as the
    reference's ``cache_shardings`` places them (`place_caches`)."""
    x, _, layer_caches, prefix = _trunk(params, batch, cfg, ctx,
                                        build_cache=True)
    if pad_to is not None:
        pad_to = pad_to + prefix
    cache = {"pos": torch.full((), x.shape[1], dtype=torch.int32,
                               device=x.device),
             "layers": _pad_cache_seq(layer_caches, cfg, pad_to)}
    if ctx.mesh is not None:
        cache["layers"], cache["kv_len"] = _hold_caches(
            cache["layers"], params, cfg, ctx)
    x = rms_norm(x[:, -1:], _top(params, "final_norm", cfg, ctx),
                 cfg.norm_eps)
    return cache, _unembed(params, x, cfg, ctx)


# --------------------------------------------------------------------- loss


def _xent(logits, targets):
    """Mean next-token cross-entropy of f32 logits [B, S, V] at int
    targets [B, S]."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean()


def _xent_split(logits, targets, ctx: ShardingCtx):
    """`_xent` of f32 logits [B, S, V / model] that hold this rank's block
    of the vocabulary over `model` (vocab-parallel, as GSPMD partitions
    the reference's loss under its ``vocab`` constraint): the row max over
    `model` taken on detached values (it cancels in the gradient), then
    one sum over `model` of each row's exps below it and of its gold
    logit, which only the rank that owns the target adds. Every rank of a
    `model` line gets the same loss, and the logits are never gathered."""
    n = logits.shape[-1]
    top = ctx.all_reduce(logits.detach().amax(-1), "max")
    local = targets.long() - ctx.index("model") * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    sums = ctx.all_reduce(torch.stack([
        torch.exp(logits - top[..., None]).sum(-1),
        torch.where(mine, gold, torch.zeros_like(gold))]), "sum")
    return (top + torch.log(sums[0]) - sums[1]).mean()


def loss_fn(params, batch, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """Next-token CE loss plus ``router_aux_coef`` x the MoE aux loss, for
    every family: batch["tokens"] and ["targets"] [B, S] (with ["frames"]
    for an enc-dec arch, ["patches"] for a VLM, whose prefix positions
    are cut before the unembedding). Returns (total, {"loss", "aux"}),
    f32 scalars. Logits that hold this rank's block of the vocabulary
    (the placed layout) take the vocab-parallel cross-entropy
    (`_xent_split`)."""
    x, aux, _, prefix = _trunk(params, batch, cfg, ctx, build_cache=False)
    if prefix:
        x = x[:, prefix:]
    x = rms_norm(x, _top(params, "final_norm", cfg, ctx), cfg.norm_eps)
    logits = _unembed(params, x, cfg, ctx, whole=False)
    loss = _xent(logits, batch["targets"]) if logits.shape[-1] == cfg.vocab \
        else _xent_split(logits, batch["targets"], ctx)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux}


def decode_step(params, cache, batch, cfg: ArchConfig,
                ctx: ShardingCtx = NULL_CTX):
    """One decode step for the whole batch at the cache's position.
    batch["tokens"]: [B, 1]; cache["pos"]: a 0-d int32 tensor on the
    caches' device, which the step never reads on the host (so that it
    replays as a CUDA graph: `runtime.steps.jit_decode_step`): an enc-dec
    decoder reads its learned position at ``min(pos, max_dec - 1)``
    through a device index. The caches are updated in place. Returns
    (logits [B, 1, V] f32, {"pos": pos + 1, a new tensor, "layers": the
    same caches, and on a mesh the same "kv_len"})."""
    dt = torch_dtype(cfg.dtype)
    pos = cache["pos"]
    x = _embed_tokens(params, batch["tokens"], cfg, ctx)
    if cfg.vlm:
        x = x * _vlm_scale(cfg)
    if cfg.enc_dec:
        table = _top(params, "dec_pos_embed", cfg, ctx)
        row = torch.clamp(torch.as_tensor(pos, device=x.device),
                          max=table.shape[0] - 1).long().reshape(1)
        x = x + table.index_select(0, row).to(dt)[None]
    x, layers = run_layers_decode(params["layers"], cache["layers"], x, cfg,
                                  ctx, pos=pos, kv_len=cache.get("kv_len"))
    x = rms_norm(x, _top(params, "final_norm", cfg, ctx), cfg.norm_eps)
    new = {"pos": pos + 1, "layers": layers}
    if "kv_len" in cache:
        new["kv_len"] = cache["kv_len"]
    return _unembed(params, x, cfg, ctx), new


# -------------------------------------------------------------- cache specs


def _cache_axes(cfg: ArchConfig, s_kv: int) -> Dict[str, tuple]:
    """Each stacked cache leaf's logical axes, for a self-attention cache
    of `s_kv` rows: K/V over ``kv_seq`` (a ring over ``seq``), the enc-dec
    cross K/V over ``kv_seq``, the SSM state and conv window."""
    seq_axis = "seq" if _is_ring(cfg, s_kv) else "kv_seq"
    kv = ("layers", "batch", seq_axis, "kv_heads", "head_dim")
    return {"k": kv, "v": kv,
            "cross_k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "cross_v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
            "h": ("layers", "batch", "ssm_heads", None, "ssm_state"),
            "conv": ("layers", "batch", "width", "conv_dim")}


def cache_specs(cfg: ArchConfig, shape: ShapeSuite) -> Dict[str, Any]:
    """The decode cache of a shape suite as a spec tree (shapes, logical
    axes (`_cache_axes`), types)."""
    b = shape.global_batch
    hd = cfg.resolved_head_dim
    n = cfg.n_layers
    dt = cfg.dtype
    s_kv = cache_seq_len(cfg, shape)
    axes = _cache_axes(cfg, s_kv)
    layer: Dict[str, ParamSpec] = {}
    if cfg.has_attention:
        for key in ("k", "v"):
            layer[key] = ParamSpec((n, b, s_kv, cfg.kv_heads, hd), axes[key],
                                   dt)
    if cfg.enc_dec:
        for key in ("cross_k", "cross_v"):
            layer[key] = ParamSpec((n, b, shape.seq_len, cfg.kv_heads, hd),
                                   axes[key], dt)
    if cfg.ssm or cfg.hybrid:
        shapes = ssm_cache_shape(cfg, b)
        layer["h"] = ParamSpec((n,) + shapes["h"][0], axes["h"], "float32")
        layer["conv"] = ParamSpec((n,) + shapes["conv"][0], axes["conv"], dt)
    return {"pos": ParamSpec((), (), "int32"), "layers": layer}


# ------------------------------------------------------------ paged decode


def paged_attn_decode(p, x, k_pool, v_pool, cfg: ArchConfig, *, block_tables,
                      lengths):
    """One-token attention against one layer's paged KV pool.

    x: [B, 1, d]; k_pool/v_pool: [NB, blk, KH, D]; lengths: [B] int32 tokens
    already stored per request (the new KV row is written at that position).
    Returns (attn_out, k_pool, v_pool)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    posv = lengths[:, None]  # [B, 1] per-request decode position
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    k_pool, v_pool = paged_cache_append(k_pool, v_pool, block_tables, lengths,
                                        k, v)
    o = paged_decode_attention(q, k_pool, v_pool, block_tables, lengths + 1)
    return _attn_out(p, o, cfg), k_pool, v_pool


def paged_attn_prefill_chunk(p, x, k_pool, v_pool, cfg: ArchConfig, *,
                             block_tables, start, n_valid):
    """Chunk attention against one layer's paged KV pool (chunked prefill).

    x: [1, C, d] — prompt hidden states at absolute positions ``start + i``
    (`start`, `n_valid`: 0-d int32 device tensors or ints); the chunk's KV
    rows are appended into the pool first (padding rows to the garbage
    page), then every query attends causally over all pool positions <= its
    own. Returns (attn_out, k_pool, v_pool)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    c = x.shape[1]
    pos = (start + torch.arange(c, dtype=torch.int64, device=x.device))[None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k_pool, v_pool = paged_cache_append_chunk(k_pool, v_pool, block_tables,
                                              start, k, v, n_valid)
    o = paged_prefill_attention(q, k_pool, v_pool, block_tables, pos)
    return _attn_out(p, o, cfg), k_pool, v_pool


def supports_paged_decode(cfg: ArchConfig) -> bool:
    """Archs the paged serving engine can drive (attention KV only): the
    reference's rule."""
    return (cfg.has_attention and not cfg.hybrid and not cfg.enc_dec
            and not cfg.vlm and not cfg.sliding_window)


def _paged_ffn(p, x, cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """The post-attention half of a paged block (the reference's
    ``_paged_ffn``): `_ffn` without the aux loss. On a mesh the paged
    steps hold their round or chunk whole on every rank, as the
    reference's paged path hands its whole activation to ``moe_layer``,
    so a MoE layer goes through `moe.moe_layer_whole`."""
    if cfg.moe and ctx.mesh is not None:
        h = rms_norm(x, p["moe_ln"], cfg.norm_eps)
        return x + moe_layer_whole(p["moe"], h, cfg, ctx)
    return _ffn(p, x, cfg, ctx, aux=False)[0]


def decode_step_paged(params, k_pools, v_pools, block_tables, lengths, batch,
                      cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX):
    """One decode step for a round of ragged requests over paged KV pools.

    batch["tokens"]: [B, 1]; lengths: [B] int32 — each request's stored token
    count (its new KV row is written there, then it attends to lengths+1
    positions). k_pools/v_pools: [L, NB, blk, KH, D], updated in place.
    On a mesh every rank holds the whole round and the whole pools (as
    the reference keeps them) and `ctx` reaches only the MoE layers
    (`_paged_ffn`) and the unembedding. Returns (logits [B, 1, V] f32,
    k_pools, v_pools)."""
    if not supports_paged_decode(cfg):
        raise ValueError(f"paged decode unsupported for family {cfg.family!r} "
                         f"(sliding_window={cfg.sliding_window})")
    x = _embed_tokens(params, batch["tokens"], cfg, ctx)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        attn_o, _, _ = paged_attn_decode(
            lp["attn"], x, k_pools[i], v_pools[i], cfg,
            block_tables=block_tables, lengths=lengths)
        x = _paged_ffn(lp, x + attn_o, cfg, ctx)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x, cfg, ctx), k_pools, v_pools


def prefill_chunk_paged(params, k_pools, v_pools, block_tables, start, batch,
                        n_valid, cfg: ArchConfig,
                        ctx: ShardingCtx = NULL_CTX):
    """One chunk of a request's prefill through the paged pipeline.

    batch["tokens"]: [1, C] right-padded chunk; start: absolute position of
    its first token; n_valid: real tokens (the rest is padding whose KV
    writes go to the garbage page). Both are 0-d int32 tensors on the
    pools' device, as the reference's traced scalars, or ints; no branch
    reads them on the host, so the step can be captured once per
    (C, table width) and replayed along the prompt. The request's block
    table must already map every position < start + n_valid. On a mesh,
    as `decode_step_paged`: a MoE layer splits the chunk's positions over
    `model` (`moe_ep_a2a`). Returns
    (last_logits [1, V] f32 at the chunk's final real token, k_pools,
    v_pools)."""
    if not supports_paged_decode(cfg):
        raise ValueError(f"paged prefill unsupported for family {cfg.family!r} "
                         f"(sliding_window={cfg.sliding_window})")
    x = _embed_tokens(params, batch["tokens"], cfg, ctx)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        attn_o, _, _ = paged_attn_prefill_chunk(
            lp["attn"], x, k_pools[i], v_pools[i], cfg,
            block_tables=block_tables, start=start, n_valid=n_valid)
        x = _paged_ffn(lp, x + attn_o, cfg, ctx)
    # the last real row, gathered at a device index (the reference's
    # dynamic_slice_in_dim): a slice would read n_valid on the host
    row = torch.as_tensor(n_valid, device=x.device).long().reshape(1) - 1
    last = x.index_select(1, row)                        # [1, 1, d]
    last = rms_norm(last, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, last, cfg, ctx)[:, 0]
    return logits, k_pools, v_pools
