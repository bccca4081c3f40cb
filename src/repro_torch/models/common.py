"""Layer library: norms, RoPE, sinusoidal positions, SwiGLU, embeddings,
full-sequence GQA attention (naive / chunked / sliding-window blocks),
decode attention over a dense KV cache (on one device, or split by
sequence over a mesh's `model` axis), and attention over paged KV pools.

Layouts follow the reference package at every public function (q
``[B, S, H, D]``, caches ``[B, S, KH, D]``, pools ``[NB, blk, KH, D]``,
block tables ``[B, M]`` int32), so the two packages are compared like with
like. Caches and pools are updated in place. Prefill attention has no
kernel in the reference and stays torch ops here; decode attention goes
through the flash-decode kernels (dense and paged).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.decode_attention import (
    flash_decode,
    paged_flash_decode,
)
from repro_torch.sharding import NULL_CTX, ShardingCtx, shard_map

NEG_INF = -1e30

# --------------------------------------------------------------------- basics


def _rms(x, eps):
    x32 = x.float()
    return x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)


def rms_norm(x, w, eps: float = 1e-5):
    return (_rms(x, eps) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [S] or [B, S]. Split-half rotation in
    f32, cast back to x's type."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # [D/2]
    angles = positions.float()[..., None] * freqs                # [..., S, D/2]
    angles = angles[..., None, :]                                # [..., S, 1, D/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos_emb(seq: int, d_model: int, dtype, device=None):
    """[seq, d_model] sinusoidal positions (sines, then cosines), computed
    in f32 and cast to `dtype`: the encoder's input positions."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / d_model)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def embed_lookup(table, tokens, ctx: ShardingCtx = NULL_CTX, vocab=None,
                 dtype=None):
    """Embedding gather: rows of `table` at `tokens`, in `dtype` (the
    table's by default). A table that holds this rank's block of the
    vocabulary over `model` (fewer rows than `vocab`, the whole count)
    looks up only its own rows, zeros for every other token, and one sum
    over `model` makes them whole: exact, as one rank adds each row."""
    if vocab is None or table.shape[0] == vocab:
        rows = table[tokens.long()]
        return rows if dtype is None else rows.to(dtype)
    n = table.shape[0]
    local = tokens.long() - ctx.index("model") * n
    mine = ((local >= 0) & (local < n))[..., None]
    rows = table[local.clamp(0, n - 1)].to(dtype or table.dtype)
    return ctx.all_reduce(rows * mine.to(rows.dtype), "sum")


def _group(q, kv_heads: int):
    """[B,S,H,D] -> [B,S,KH,G,D] grouped-query layout (no KV repeat)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, d)


# ------------------------------------------------------------------ attention


def _mask(q_pos, k_pos, *, causal: bool, window: int, prefix: int):
    """q_pos: [Sq,1] int, k_pos: [1,Sk] int -> bool [Sq,Sk] (True=keep)."""
    if not causal:
        return torch.ones((q_pos.shape[0], k_pos.shape[1]), dtype=torch.bool,
                          device=q_pos.device)
    ok = k_pos <= q_pos
    if window:
        ok &= k_pos > (q_pos - window)
    if prefix:
        ok |= k_pos < prefix
    return ok


def attention_naive(q, k, v, *, q_pos, k_pos, causal=True, window=0, prefix=0):
    """Materialized-scores attention. [B,Sq,H,D] x [B,Sk,KH,D] -> [B,Sq,H,D].
    Scores in f32, probabilities cast to q's type before the product with
    V, as in the reference."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = _group(q, kh) * (d ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    m = _mask(q_pos[:, None], k_pos[None, :], causal=causal, window=window,
              prefix=prefix)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(b, sq, h, d)


def attention_chunked(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                      prefix=0, chunk=1024):
    """Online-softmax loop over KV chunks (memory O(Sq*chunk) instead of
    Sq*Sk)."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if sk % chunk != 0 or sk <= chunk:
        return attention_naive(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               causal=causal, window=window, prefix=prefix)
    g = h // kh
    qg = (_group(q, kh) * (d ** -0.5)).to(q.dtype)
    acc = torch.zeros((b, kh, g, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    for c in range(sk // chunk):
        kc = k[:, c * chunk:(c + 1) * chunk]
        vc = v[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float())
        msk = _mask(q_pos[:, None], k_pos[None, c * chunk:(c + 1) * chunk],
                    causal=causal, window=window, prefix=prefix)
        s = s.masked_fill(~msk, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vc).float()
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / l[..., None].clamp_min(1e-30)            # [b,kh,g,sq,d]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, kh * g, d).to(q.dtype)


def attention_swa_block(q, k, v, *, q_pos, window: int, chunk: int):
    """Block-local sliding-window attention: each query chunk attends only
    to its own and the previous key chunk, O(S * 2c) score work instead of
    O(S * S). Needs window <= chunk, self-attention and S % chunk == 0.
    Scores in f32, probabilities cast to q's type before the product with
    V, as in the reference."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    nc = s // chunk
    qc = (_group(q, kh) * (d ** -0.5)).reshape(b, nc, chunk, kh, g, d)
    kc = k.reshape(b, nc, chunk, kh, d)
    vc = v.reshape(b, nc, chunk, kh, d)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kk = torch.cat([kprev, kc], dim=2)                       # [b,nc,2c,kh,d]
    vv = torch.cat([vprev, vc], dim=2)
    sc = torch.einsum("bcqkgd,bcskd->bckgqs", qc.float(), kk.float())
    qp = q_pos.reshape(nc, chunk)
    kp = torch.cat([qp - chunk, qp], dim=1)                  # [nc, 2c]
    msk = ((kp[:, None, :] <= qp[:, :, None])
           & (kp[:, None, :] > qp[:, :, None] - window)
           & (kp[:, None, :] >= 0))
    sc = sc.masked_fill(~msk[None, :, None, None], NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    o = torch.einsum("bckgqs,bcskd->bcqkgd", p, vv)
    return o.reshape(b, s, h, d)


def attention(q, k, v, *, q_pos, k_pos, causal=True, window=0, prefix=0,
              impl="auto", chunk=1024):
    """Full-sequence attention, the reference's dispatch: the
    sliding-window block form for causal windowed self-attention over at
    least two whole chunks, the naive form up to max(chunk, 4096) keys, the
    chunked one beyond."""
    s_q, s_kv = q.shape[1], k.shape[1]
    if impl == "swa_block" or (
        impl == "auto" and causal and window and not prefix
        and s_q == s_kv and window <= chunk and s_q % chunk == 0
        and s_q >= 2 * chunk
    ):
        return attention_swa_block(
            q, k, v, q_pos=q_pos, window=window,
            chunk=max(window, chunk if s_q % chunk == 0 else window))
    if impl == "naive" or (impl == "auto" and s_kv <= max(chunk, 4096)):
        return attention_naive(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               causal=causal, window=window, prefix=prefix)
    return attention_chunked(q, k, v, q_pos=q_pos, k_pos=k_pos,
                             causal=causal, window=window, prefix=prefix,
                             chunk=chunk)


# --------------------------------------------------- decode over a dense cache


def _single_decode(q, k_cache, v_cache, new_k, new_v, pos, update=True):
    """Unsharded decode attention: write the new K/V row at `pos` in place
    (clamped into the cache, as the reference's dynamic_update_slice is),
    then attend every position <= pos through the flash-decode kernel (its
    plain version on CPU tensors).

    q: [B, 1, H, D]; k_cache/v_cache: [B, S, KH, D]; new_k/new_v:
    [B, 1, KH, D] (unused without `update`: a cross-attention cache is
    read only); pos: a 0-d int32 tensor on the cache's device (the
    engine's), or an int. A tensor `pos` is never read on the host: the row
    is written at a device index and K3 reads it on the device, so the step
    replays in a CUDA graph. Returns (out [B, 1, H, D], k_cache, v_cache)."""
    if update:
        row = torch.as_tensor(pos, device=k_cache.device).reshape(1)
        row = row.clamp(0, k_cache.shape[1] - 1).long()
        k_cache.index_copy_(1, row, new_k.to(k_cache.dtype))
        v_cache.index_copy_(1, row, new_v.to(v_cache.dtype))
    out = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, pos)
    return out[:, None], k_cache, v_cache


# ------------------------------------- decode over a sequence-sharded cache


def _row_update(cache, new_row, safe, in_range):
    """Row-granular cache write, in place: read the one row at `safe`,
    select the new row where `in_range` (a 0-d bool tensor), write the row
    back (the reference's `cache_update="row"`, which cuts decode cache
    traffic ~3x against a whole-cache select)."""
    old = cache.index_select(1, safe)
    cache.index_copy_(1, safe, torch.where(in_range, new_row.to(cache.dtype),
                                           old))
    return cache


def _full_update(cache, new_row, safe, in_range):
    """Whole-cache write, in place: the cache with the new row at `safe`,
    selected over the whole cache where `in_range` (the reference's
    `cache_update="full"`: an updated copy, then a select)."""
    upd = cache.index_copy(1, safe, new_row.to(cache.dtype))
    cache.copy_(torch.where(in_range, upd, cache))
    return cache


def _decode_core(ctx: ShardingCtx, q, k_cache, v_cache, new_k, new_v, pos, *,
                 s_local: int, update=True, update_mode="full"):
    """One rank's part of the sequence-sharded decode (the reference's
    shard_map body). Shapes are this rank's:

      q:            [B, 1, H, D]    (the same on every rank of `model`)
      k/v_cache:    [B, S_l, KH, D] (shard `ctx.index("model")` of the
                    sequence: positions offset .. offset + S_l - 1)
      new_k/new_v:  [B, 1, KH, D]
      pos:          0-d int32 tensor (or an int): the cache is live in
                    [0, pos]

    The new row lands only on the shard that owns `pos`, at a device index
    (`pos` is never read on the host). The flash-decode kernel attends the
    shard's live rows at ``pos - offset`` and returns each head's (o, lse);
    the shards merge them over `model`: M = max lse, then the sums of
    exp(lse - M) o and of exp(lse - M), then their quotient. This is the
    reference's pmax/psum over its unnormalised partials, on the kernel's
    normalised ones; M is held finite, so a shard with no live key (lse
    -inf, o 0) weighs 0 and never forms inf - inf. Returns (out [B, 1, H,
    D] in q's type, k_cache, v_cache), the caches updated in place."""
    if update_mode not in ("full", "row"):
        raise ValueError(f"cache_update is full or row, got {update_mode!r}")
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_cache.device)
    local = pos.reshape(()) - ctx.index("model") * s_local
    if update:
        in_range = (local >= 0) & (local < s_local)
        safe = local.clamp(0, s_local - 1).long().reshape(1)
        write = _row_update if update_mode == "row" else _full_update
        write(k_cache, new_k, safe, in_range)
        write(v_cache, new_v, safe, in_range)
    o, lse = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, local,
                          return_lse=True)
    m = ctx.all_reduce(lse, "max").clamp_min(NEG_INF)
    w = torch.exp(lse - m)                                    # [B, H]
    part = torch.cat([o.float() * w[..., None], w[..., None]], dim=-1)
    part = ctx.all_reduce(part, "sum")  # [B, H, D + 1]: numerator, denominator
    out = part[..., :-1] / part[..., -1:].clamp_min(1e-30)
    return out.to(q.dtype)[:, None], k_cache, v_cache


def flash_decode_attention(ctx: ShardingCtx, q, k_cache, v_cache, new_k,
                           new_v, pos, update=True, update_mode="full", *,
                           s_total=None):
    """Sequence-sharded decode attention (context parallelism over
    `model`). On a mesh each rank holds its shard of the cache, and
    `s_total` is the whole cache's length: a multiple of the `model` axis
    splits it (`_decode_core`); any other length, no `model` axis, or no
    mesh leaves the cache whole on every rank and takes `_single_decode`,
    as the reference does."""
    if ctx.mesh is None or "model" not in ctx.axis_sizes \
            or not ctx.use_shard_map:
        return _single_decode(q, k_cache, v_cache, new_k, new_v, pos, update)
    if s_total is None:
        raise ValueError("on a mesh, s_total (the whole cache's length) "
                         "says how the cache is held")
    n_model = ctx.axis_sizes["model"]
    if s_total % n_model != 0:
        if k_cache.shape[1] != s_total:
            raise ValueError(f"a cache of {s_total} rows, which {n_model} "
                             f"model ranks do not split, is held whole; got "
                             f"{k_cache.shape[1]} rows")
        return _single_decode(q, k_cache, v_cache, new_k, new_v, pos, update)
    dp = tuple(a for a in ctx.mesh.axis_names if a in ("pod", "data"))
    bspec = dp if len(dp) > 1 else (dp[0] if dp else None)
    q_s, cache_s = (bspec,), (bspec, "model")
    cache_whole = (None, s_total, None, None)
    fn = functools.partial(_decode_core, ctx, s_local=s_total // n_model,
                           update=update, update_mode=update_mode)
    return shard_map(fn, ctx=ctx,
                     in_specs=(q_s, cache_s, cache_s, q_s, q_s, ()),
                     out_specs=(q_s, cache_s, cache_s))(
        q, k_cache, v_cache, new_k, new_v, pos,
        whole=(None, cache_whole, cache_whole, None, None, None))


def decode_attention(ctx: ShardingCtx, q, k_cache, v_cache, new_k, new_v,
                     pos, update=True, update_mode="full", *, s_total=None):
    """Public decode-attention entry over a dense cache: the
    sequence-sharded flash decode when a mesh exists, else one device's."""
    if ctx.mesh is None:
        return _single_decode(q, k_cache, v_cache, new_k, new_v, pos, update)
    return flash_decode_attention(ctx, q, k_cache, v_cache, new_k, new_v, pos,
                                  update, update_mode, s_total=s_total)


# --------------------------------------------------------- paged KV (serving)


def paged_cache_append(k_pool, v_pool, block_tables, lengths, new_k, new_v):
    """Write one new KV row per request into its paged block, in place.

    k_pool/v_pool: [NB, blk, KH, D] one layer's block pool; block_tables:
    [B, M] int32 block ids; lengths: [B] int32 tokens already stored — row b
    lands in block `block_tables[b, lengths[b] // blk]` at offset
    `lengths[b] % blk`. new_k/new_v: [B, 1, KH, D]. Requests own disjoint
    blocks (the pager's invariant) so the scatter indices never collide,
    except padding rows which all target the reserved garbage block 0 —
    which of them lands there does not matter. Returns the pools."""
    b = lengths.shape[0]
    blk = k_pool.shape[1]
    lengths = lengths.long()
    rows = torch.arange(b, device=lengths.device)
    bids = block_tables.long()[rows, lengths // blk]
    offs = lengths % blk
    k_pool[bids, offs] = new_k[:, 0].to(k_pool.dtype)
    v_pool[bids, offs] = new_v[:, 0].to(v_pool.dtype)
    return k_pool, v_pool


def paged_cache_append_chunk(k_pool, v_pool, block_tables, start, new_k,
                             new_v, n_valid):
    """Write a chunk of consecutive KV rows into paged blocks, in place.

    Rows ``i < n_valid`` of the (right-padded) chunk land at logical
    positions ``start + i`` through the block table; padding rows go to the
    reserved garbage block 0 so they never clobber real pages.

    k_pool/v_pool: [NB, blk, KH, D]; block_tables: [B, M] int32; start /
    n_valid: 0-d int32 tensors on the pools' device (the reference's
    ``[] int32``) or ints, one request per call; new_k/new_v:
    [B, C, KH, D]. Nothing here reads them on the host, so a captured
    chunk step replays at any `start` / `n_valid` written into its
    buffers. Returns the pools."""
    b, c = new_k.shape[0], new_k.shape[1]
    blk = k_pool.shape[1]
    m = block_tables.shape[1]
    dev = new_k.device
    idx = torch.arange(c, device=dev)
    pos = start + idx                                    # [C] absolute positions
    bi = torch.clamp(pos // blk, max=m - 1)
    bids = block_tables.long()[:, bi]                    # [B, C]
    valid = (idx < n_valid) & (pos // blk < m)
    bids = torch.where(valid[None, :], bids, torch.zeros_like(bids))
    offs = (pos % blk).expand(b, c)
    k_pool[bids, offs] = new_k.to(k_pool.dtype)
    v_pool[bids, offs] = new_v.to(v_pool.dtype)
    return k_pool, v_pool


def paged_prefill_attention(q, k_pool, v_pool, block_tables, q_pos):
    """Causal chunk attention against a paged KV cache (chunked prefill).

    q: [B, C, H, D] at absolute positions `q_pos` [B, C]; query i attends
    every pool position <= q_pos[b, i] through the block table. Scores are
    taken in f32 (bf16 products are exact there), the probabilities cast to
    q's type before the product with V, as in the reference. Returns
    [B, C, H, D]; padded query rows produce garbage the caller discards."""
    b, c, h, d = q.shape
    blk, kh = k_pool.shape[1], k_pool.shape[2]
    m = block_tables.shape[1]
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, m * blk, kh, d)
    v = v_pool[bt].reshape(b, m * blk, kh, d)
    qg = _group(q, kh) * (d ** -0.5)                     # [B,C,KH,G,D]
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    pos = torch.arange(m * blk, device=q.device)
    valid = pos[None, None, :] <= q_pos[:, :, None]      # [B,C,S]
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(b, c, h, d)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           depth=None):
    """Decode attention over a paged KV cache, through the paged
    flash-decode kernel on CUDA tensors and its plain version on CPU ones.

    q: [B, 1, H, D]; k_pool/v_pool: [NB, blk, KH, D]; block_tables: [B, M]
    int32 (padded with the garbage block 0); lengths: [B] int32 — request b
    attends key positions < lengths[b]. Returns [B, 1, H, D]. Rows with
    lengths == 0 (padding slots in a round) produce finite garbage the
    caller discards."""
    out = paged_flash_decode(q[:, 0].contiguous(), k_pool, v_pool,
                             block_tables, lengths, depth=depth)
    return out[:, None]
