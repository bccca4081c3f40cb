"""Layer library for the paged serving path: norms, RoPE, SwiGLU,
embeddings, and attention over paged KV pools.

Layouts follow the reference package at every public function (q
``[B, S, H, D]``, pools ``[NB, blk, KH, D]``, block tables ``[B, M]``
int32), so the two packages are compared like with like. The pools are
updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.decode_attention import (
    paged_flash_decode,
)

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


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def embed_lookup(table, tokens):
    """Embedding gather: rows of `table` at `tokens`."""
    return table[tokens.long()]


def _group(q, kv_heads: int):
    """[B,S,H,D] -> [B,S,KH,G,D] grouped-query layout (no KV repeat)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, d)


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


def paged_cache_append_chunk(k_pool, v_pool, block_tables, start: int,
                             new_k, new_v, n_valid: int):
    """Write a chunk of consecutive KV rows into paged blocks, in place.

    Rows ``i < n_valid`` of the (right-padded) chunk land at logical
    positions ``start + i`` through the block table; padding rows go to the
    reserved garbage block 0 so they never clobber real pages.

    k_pool/v_pool: [NB, blk, KH, D]; block_tables: [B, M] int32; start /
    n_valid: ints (one request per call); new_k/new_v: [B, C, KH, D].
    Returns the pools."""
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
