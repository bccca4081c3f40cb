"""The LM's serving paths: parameter specs; the dense engine's one-shot
prefill and one-token decode over ``[L, B, S, KH, D]`` caches; and the
paged engine's decode over paged KV pools for a round of ragged requests
and chunked prefill into the pools.

Parameters keep the reference package's tree — names, shapes and the
stacked ``layers`` axis (``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, ...).
The reference scans the layer stack; here a Python loop walks the stacked
axis and each layer writes its cache rows (or its SSM state) into its
slice of the stacked caches or pools in place. The functions still return
the caches, so callers read the same as against the reference.

Families: attention LMs with a dense SwiGLU FFN (yi-6b, granite-3-2b,
internlm2-20b, command-r-plus-104b) or a MoE FFN (granite-moe-1b-a400m,
qwen3-moe-30b-a3b; `models/moe.py`, whose expert matmuls are the `moe_gmm`
kernel), on both engines; the Mamba-2 SSM family (mamba2-130m;
`models/ssm.py`, whose prefill scan is the `ssd_scan` kernel) on the dense
engine. Dense decode attention is the `flash_decode` kernel, paged decode
attention the `paged_decode` kernel. The hybrid, encoder-decoder and VLM
families, and sliding-window caches, wait for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
    swiglu,
)
from repro_torch.models.moe import moe_layer, moe_param_specs
from repro_torch.models.params import ParamSpec, map_specs, torch_dtype
from repro_torch.models.ssm import ssm_decode, ssm_forward, ssm_param_specs

LATER_SLICE = ("the hybrid, encoder-decoder and VLM families and sliding-"
               "window caches wait for a later slice of the port (ROADMAP "
               "Queue 1, \"Hybrid and the other families\")")

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


def _check_family(cfg: ArchConfig) -> None:
    """Refuse the families this package does not serve yet."""
    if cfg.hybrid or cfg.enc_dec or cfg.vlm or cfg.sliding_window:
        raise NotImplementedError(f"arch {cfg.name!r} (family={cfg.family}): "
                                  f"{LATER_SLICE}")


def _layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    if cfg.family == "ssm":
        return {"ssm_ln": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
                "ssm": ssm_param_specs(cfg)}
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
    """The parameter tree of a dense, MoE or SSM arch, in the reference's
    names and shapes."""
    _check_family(cfg)
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
    reference's ``_paged_ffn``. The MoE router's aux loss is dropped: it
    serves training, which this package does not run yet."""
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


# ------------------------------------------------ dense prefill and decode


def attn_full(p, x, cfg: ArchConfig, *, positions):
    """Full-sequence causal self-attention block (prefill). Returns
    (attn_out, (k, v)) with the roped keys and the values, for the cache."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, q_pos=positions, k_pos=positions, causal=True,
                  window=cfg.sliding_window, impl=cfg.attn_impl,
                  chunk=cfg.attn_chunk)
    return _attn_out(p, o), (k, v)


def attn_decode(p, x, cache, cfg: ArchConfig, *, pos, cross=False):
    """One-token self-attention against a dense KV cache: the new row is
    written at `pos` (a 0-d int32 tensor on x's device) in place, then the
    flash-decode kernel attends every position <= pos. Returns (attn_out,
    (k_cache, v_cache))."""
    kc, vc = cache
    if cross:
        raise NotImplementedError(f"cross-attention decode: {LATER_SLICE}")
    if cfg.sliding_window and kc.shape[1] <= cfg.sliding_window:
        raise NotImplementedError(f"ring (sliding-window) decode: "
                                  f"{LATER_SLICE}")
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h)
    posv = torch.as_tensor(pos, device=x.device).reshape(1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    o, kc, vc = decode_attention(q, kc, vc, k, v, pos)
    return _attn_out(p, o), (kc, vc)


def block_full(p, x, cfg: ArchConfig, *, positions, build_cache=False):
    """One layer, full sequence. Returns (x, cache_entry): K/V for an
    attention layer, the final SSM and conv states for an SSM layer, or
    nothing without `build_cache`. (The reference also returns the MoE
    aux loss, which serves training.)"""
    if cfg.family == "ssm":
        h = rms_norm(x, p["ssm_ln"], cfg.norm_eps)
        if build_cache:
            out, h_fin, conv = ssm_forward(p["ssm"], h, cfg, return_state=True)
            return x + out, {"h": h_fin, "conv": conv}
        return x + ssm_forward(p["ssm"], h, cfg), {}
    attn_o, (k, v) = attn_full(p["attn"], x, cfg, positions=positions)
    x = _ffn(p, x + attn_o, cfg)
    return x, ({"k": k, "v": v} if build_cache else {})


def block_decode(p, x, layer_cache, cfg: ArchConfig, *, pos):
    """One layer, one token. Returns (x, new_layer_cache); the attention
    cache is updated in place (the same tensors come back)."""
    if cfg.family == "ssm":
        h = rms_norm(x, p["ssm_ln"], cfg.norm_eps)
        out, st = ssm_decode(p["ssm"], {"h": layer_cache["h"],
                                        "conv": layer_cache["conv"]}, h, cfg)
        return x + out, st
    attn_o, (kc, vc) = attn_decode(p["attn"], x,
                                   (layer_cache["k"], layer_cache["v"]), cfg,
                                   pos=pos)
    return _ffn(p, x + attn_o, cfg), {"k": kc, "v": vc}


def run_layers_full(layers, x, cfg: ArchConfig, *, positions,
                    build_cache=False):
    """Apply all layers in a Python loop over the stacked axis. Returns
    (x, stacked_cache) with each cache leaf stacked to [L, ...]."""
    entries = []
    for i in range(cfg.n_layers):
        x, cache = block_full(_layer(layers, i), x, cfg, positions=positions,
                              build_cache=build_cache)
        entries.append(cache)
    caches = {k: torch.stack([e[k] for e in entries])
              for k in entries[0]} if entries and entries[0] else {}
    return x, caches


def run_layers_decode(layers, caches, x, cfg: ArchConfig, *, pos):
    """All layers for one token. Layer i updates its slice of every stacked
    cache leaf ([L, B, S, KH, D] K/V rows, [L, B, H, P, N] SSM state, ...)
    in place; no leaf is re-stacked. Returns (x, caches)."""
    for i in range(cfg.n_layers):
        lc = _layer(caches, i)
        x, nc = block_decode(_layer(layers, i), x, lc, cfg, pos=pos)
        for key, new in nc.items():
            if new is not lc[key]:
                lc[key].copy_(new)
    return x, caches


def _embed_in(params, batch, cfg: ArchConfig):
    """Token embedding (no VLM frontend). Returns (x, positions)."""
    x = embed_lookup(params["embed"], batch["tokens"]).to(torch_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _pad_cache_seq(layer_caches, pad_to: Optional[int]):
    """Pad the attention caches along seq so decode can write past the
    prompt (the reference's, without its sliding-window ring case)."""
    out = dict(layer_caches)
    for key in ("k", "v"):
        if key in out and pad_to and out[key].shape[2] < pad_to:
            kv = out[key]  # [L, B, S, KH, D]
            out[key] = F.pad(kv, (0, 0, 0, 0, 0, pad_to - kv.shape[2]))
    return out


def prefill(params, batch, cfg: ArchConfig, pad_to: Optional[int] = None):
    """Build decode state from a full prompt. batch["tokens"]: [B, S].
    Returns (cache, last_logits [B, 1, V] f32); cache = {"pos": S (a 0-d
    int32 tensor on the tokens' device, as the reference's is), "layers":
    stacked per-layer caches, K/V padded to `pad_to` rows}."""
    _check_family(cfg)
    x, positions = _embed_in(params, batch, cfg)
    x, layer_caches = run_layers_full(params["layers"], x, cfg,
                                      positions=positions, build_cache=True)
    cache = {"pos": torch.full((), x.shape[1], dtype=torch.int32,
                               device=x.device),
             "layers": _pad_cache_seq(layer_caches, pad_to)}
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return cache, _unembed(params, x)


def decode_step(params, cache, batch, cfg: ArchConfig):
    """One decode step for the whole batch at the cache's position.
    batch["tokens"]: [B, 1]; cache["pos"]: a 0-d int32 tensor on the
    caches' device, which the step never reads on the host (so that it
    replays as a CUDA graph: `launch.serve.jit_decode_step`). The caches
    are updated in place. Returns (logits [B, 1, V] f32, {"pos": pos + 1, a
    new tensor, "layers": the same caches})."""
    _check_family(cfg)
    pos = cache["pos"]
    x = embed_lookup(params["embed"], batch["tokens"]).to(torch_dtype(cfg.dtype))
    x, layers = run_layers_decode(params["layers"], cache["layers"], x, cfg,
                                  pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x), {"pos": pos + 1, "layers": layers}


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


def prefill_chunk_paged(params, k_pools, v_pools, block_tables, start, batch,
                        n_valid, cfg: ArchConfig):
    """One chunk of a request's prefill through the paged pipeline.

    batch["tokens"]: [1, C] right-padded chunk; start: absolute position of
    its first token; n_valid: real tokens (the rest is padding whose KV
    writes go to the garbage page). Both are 0-d int32 tensors on the
    pools' device, as the reference's traced scalars, or ints; no branch
    reads them on the host, so the step can be captured once per
    (C, table width) and replayed along the prompt. The request's block
    table must already map every position < start + n_valid. Returns
    (last_logits [1, V] f32 at the chunk's final real token, k_pools,
    v_pools)."""
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
    # the last real row, gathered at a device index (the reference's
    # dynamic_slice_in_dim): a slice would read n_valid on the host
    row = torch.as_tensor(n_valid, device=x.device).long().reshape(1) - 1
    last = x.index_select(1, row)                        # [1, 1, d]
    last = rms_norm(last, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, last)[:, 0]
    return logits, k_pools, v_pools
