"""Public flash-decode ops (dense and paged) with latency-aware depth
selection: ``depth=None`` solves the pipeline depth from the kernel's
`CoroSpec` (`decode_attention.decode_spec`, `paged_decode_spec`) through
core.autotune."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.decode_attention.decode_attention import (
    flash_decode,
    paged_flash_decode,
)

__all__ = ["decode_attention", "paged_decode_attention"]


def decode_attention(q, k_cache, v_cache, pos, *, blk: int = 128,
                     depth: Optional[int] = None):
    """q: [B,H,D]; caches: [B,S,KH,D]; attend positions <= pos."""
    return flash_decode(q, k_cache, v_cache, pos, blk=blk, depth=depth)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           depth: Optional[int] = None):
    """Ragged-batch decode over a paged KV block pool (see
    `decode_attention.paged_flash_decode`)."""
    return paged_flash_decode(q, k_pool, v_pool, block_tables, lengths,
                              depth=depth)
