"""The LM's paged serving path: parameter specs, one-token decode over paged
KV pools for a round of ragged requests, and chunked prefill into the pools.

Parameters keep the reference package's tree — names, shapes and the
stacked ``layers`` axis (``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, ...).
The reference scans the layer stack; here a Python loop walks the stacked
axis and each layer writes its KV rows into its slice of the
``[L, NB+1, blk, KH, D]`` pools in place. The functions still return the
pools, so callers read the same as against the reference.

Served families: attention LMs with a dense SwiGLU FFN (yi-6b,
granite-3-2b, internlm2-20b, command-r-plus-104b) or a MoE FFN
(granite-moe-1b-a400m, qwen3-moe-30b-a3b; `models/moe.py`, whose expert
matmuls are the `moe_gmm` kernel). Recurrent state, cross-attention and
sliding-window caches are not on this path.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    apply_rope,
    embed_lookup,
    paged_cache_append,
    paged_cache_append_chunk,
    paged_decode_attention,
    paged_prefill_attention,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import moe_layer, moe_param_specs
from repro_torch.models.params import ParamSpec, map_specs, torch_dtype

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


def _layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {"attn": _attn_specs(cfg)}
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
    """The parameter tree of a paged-servable arch (see
    `supports_paged_decode`), in the reference's names and shapes."""
    if not supports_paged_decode(cfg):
        raise ValueError(f"arch {cfg.name!r} (family={cfg.family}) is not on "
                         "the paged serving path of this package")
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "layers": _stack(_layer_specs(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    return map_specs(
        lambda s: ParamSpec(s.shape, s.axes, cfg.param_dtype, s.init, s.scale),
        specs)


# ---------------------------------------------------------------- attention


def _project_qkv(p, h):
    b, s, d = h.shape
    dt = h.dtype

    def proj(w):
        return (h @ w.to(dt).reshape(d, -1)).reshape(b, s, w.shape[1],
                                                     w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _attn_out(p, o):
    b, s, h, hd = o.shape
    out = o.reshape(b, s, h * hd) @ p["wo"].to(o.dtype).reshape(h * hd, -1)
    if "bo" in p:
        out = out + p["bo"].to(o.dtype)
    return out


def _ffn(p, x, cfg: ArchConfig):
    """The post-attention half of a block (MoE or SwiGLU MLP): the
    reference's ``_paged_ffn``."""
    if cfg.moe:
        h = rms_norm(x, p["moe_ln"], cfg.norm_eps)
        moe_o, _ = moe_layer(p["moe"], h, cfg)
        return x + moe_o
    m = p["mlp"]
    h = rms_norm(x, m["ln"], cfg.norm_eps)
    return x + swiglu(h, m["w_gate"].to(h.dtype), m["w_up"].to(h.dtype),
                      m["w_down"].to(h.dtype))


def _layer(layers, i: int):
    """Layer `i`'s parameters: the i-th slice of every stacked leaf."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _unembed(params, x):
    dt = x.dtype
    table = params.get("lm_head")
    if table is None:
        logits = x @ params["embed"].to(dt).T
    else:
        logits = x @ table.to(dt)
    return logits.float()


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
    return _attn_out(p, o), k_pool, v_pool


def paged_attn_prefill_chunk(p, x, k_pool, v_pool, cfg: ArchConfig, *,
                             block_tables, start: int, n_valid: int):
    """Chunk attention against one layer's paged KV pool (chunked prefill).

    x: [1, C, d] — prompt hidden states at absolute positions ``start + i``;
    the chunk's KV rows are appended into the pool first (padding rows to
    the garbage page), then every query attends causally over all pool
    positions <= its own. Returns (attn_out, k_pool, v_pool)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    c = x.shape[1]
    pos = (start + torch.arange(c, dtype=torch.int64, device=x.device))[None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    k_pool, v_pool = paged_cache_append_chunk(k_pool, v_pool, block_tables,
                                              start, k, v, n_valid)
    o = paged_prefill_attention(q, k_pool, v_pool, block_tables, pos)
    return _attn_out(p, o), k_pool, v_pool


def supports_paged_decode(cfg: ArchConfig) -> bool:
    """Archs the paged serving engine can drive (attention KV only): the
    reference's rule."""
    return (cfg.has_attention and not cfg.hybrid and not cfg.enc_dec
            and not cfg.vlm and not cfg.sliding_window)


def decode_step_paged(params, k_pools, v_pools, block_tables, lengths, batch,
                      cfg: ArchConfig):
    """One decode step for a round of ragged requests over paged KV pools.

    batch["tokens"]: [B, 1]; lengths: [B] int32 — each request's stored token
    count (its new KV row is written there, then it attends to lengths+1
    positions). k_pools/v_pools: [L, NB, blk, KH, D], updated in place.
    Returns (logits [B, 1, V] f32, k_pools, v_pools)."""
    if not supports_paged_decode(cfg):
        raise ValueError(f"paged decode unsupported for family {cfg.family!r} "
                         f"(sliding_window={cfg.sliding_window})")
    dt = torch_dtype(cfg.dtype)
    x = embed_lookup(params["embed"], batch["tokens"]).to(dt)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        attn_o, _, _ = paged_attn_decode(
            lp["attn"], x, k_pools[i], v_pools[i], cfg,
            block_tables=block_tables, lengths=lengths)
        x = _ffn(lp, x + attn_o, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x), k_pools, v_pools


def prefill_chunk_paged(params, k_pools, v_pools, block_tables, start: int,
                        batch, n_valid: int, cfg: ArchConfig):
    """One chunk of a request's prefill through the paged pipeline.

    batch["tokens"]: [1, C] right-padded chunk; start: absolute position of
    its first token; n_valid: real tokens (the rest is padding whose KV
    writes go to the garbage page). The request's block table must already
    map every position < start + n_valid. Returns (last_logits [1, V] f32 at
    the chunk's final real token, k_pools, v_pools)."""
    if not supports_paged_decode(cfg):
        raise ValueError(f"paged prefill unsupported for family {cfg.family!r} "
                         f"(sliding_window={cfg.sliding_window})")
    dt = torch_dtype(cfg.dtype)
    x = embed_lookup(params["embed"], batch["tokens"]).to(dt)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        attn_o, _, _ = paged_attn_prefill_chunk(
            lp["attn"], x, k_pools[i], v_pools[i], cfg,
            block_tables=block_tables, start=start, n_valid=n_valid)
        x = _ffn(lp, x + attn_o, cfg)
    last = x[:, n_valid - 1:n_valid]                     # [1, 1, d]
    last = rms_norm(last, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, last)[:, 0]
    return logits, k_pools, v_pools
