"""Paged KV-cache block manager: fixed-size HBM pages, per-request tables,
refcounted sharing with copy-on-write.

The serving-side analogue of the paper's far-memory arena: the KV cache is
not a dense ``[batch, max_len]`` allocation but a pool of fixed-size blocks
("pages") in HBM, and each request owns a *block table* — the list of pages
its logical positions map onto. Pages are the coroutine tiles of the paged
decode kernel (`kernels/decode_attention.paged_flash_decode`): the pipeline
fetches them through the table, so physical placement is free and freed
pages are reused immediately (defrag-free by construction — no page ever
needs to move).

With the prefix cache, pages are **refcounted**: a page
may be referenced by several request tables at once (a shared prompt
prefix) and/or by the radix prefix index (`serve/prefix_cache.py`). `free`
only returns a page to the free list when its last reference drops;
`ensure_writable` implements copy-on-write — before a request writes a KV
row into a shared page, the page is forked (a fresh page replaces it in
that request's table and the caller copies the contents).

This module is pure host-side bookkeeping (no tensors): the engine owns the
actual pool arrays and indexes them with the tables produced here.

Layout convention (shared with models.lm / the kernel): block id 0 is a
reserved *garbage* page that is never allocated. Round padding slots point
every table entry at it, so their masked-out scatters/gathers land somewhere
harmless. A pool advertising `num_blocks` usable pages is therefore
physically `num_blocks + 1` blocks (`KVPager.physical_blocks`).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.faults import NULL_INJECTOR

GARBAGE_BLOCK = 0


class PoolExhausted(RuntimeError):
    """No free block available (caller should evict, preempt or wait)."""


class KVPager:
    """Block pool allocator: alloc/append/share/fork/free with leak-proof
    refcounted accounting."""

    def __init__(self, num_blocks: int, block_size: int, *,
                 faults=NULL_INJECTOR):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need >=1 blocks of >=1 tokens, got "
                             f"{num_blocks}x{block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.faults = faults  # serve.faults hook ("pool_exhausted" site)
        # block ids 1..num_blocks; 0 is the reserved garbage page
        self._free = deque(range(1, self.num_blocks + 1))
        self._refcounts: Dict[int, int] = {}
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}
        self.blocks_allocated = 0  # cumulative free-list pops (cold + forks)

    # ------------------------------------------------------------- queries

    @property
    def physical_blocks(self) -> int:
        """Blocks the engine must allocate (usable pool + garbage page 0)."""
        return self.num_blocks + 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def pool_tokens(self) -> int:
        """Token capacity of the usable pool."""
        return self.num_blocks * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.block_size)

    def can_alloc(self, n_tokens: int, *, shared: int = 0) -> bool:
        """Can `n_tokens` be stored given `shared` already-resident prefix
        blocks (which cost no free-list pops)?"""
        return self.blocks_for(n_tokens) - shared <= self.free_blocks

    def owns(self, rid: int) -> bool:
        return rid in self._tables

    def length(self, rid: int) -> int:
        return self._lengths[rid]

    def block_table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def refcount(self, block: int) -> int:
        """References on an allocated block (owners + external/cache refs)."""
        return self._refcounts.get(block, 0)

    def padded_table(self, rid: int, max_blocks: int) -> np.ndarray:
        """Block table padded with the garbage page to a fixed width."""
        t = self._tables[rid]
        if len(t) > max_blocks:
            raise ValueError(f"request {rid} uses {len(t)} blocks > "
                             f"table width {max_blocks}")
        out = np.full((max_blocks,), GARBAGE_BLOCK, np.int32)
        out[: len(t)] = t
        return out

    # ----------------------------------------------------------- lifecycle

    def _pop_free(self) -> int:
        if self.faults.fire("pool_exhausted", free=len(self._free)):
            raise PoolExhausted("injected fault: pool_exhausted")
        if not self._free:
            raise PoolExhausted("no free block in the pool")
        b = self._free.popleft()
        self._refcounts[b] = 1
        self.blocks_allocated += 1
        return b

    def alloc(self, rid: int, n_tokens: int, *,
              prefix_blocks: Sequence[int] = (),
              prefix_len: int = 0) -> List[int]:
        """Claim blocks for `n_tokens` stored tokens. Returns the request's
        block table; raises `PoolExhausted` leaving state intact.

        `prefix_blocks` are already-allocated shared pages (a prefix-cache
        hit) covering the first `prefix_len` tokens — the last one may be
        only partially valid. They are refcounted into the table instead of
        popping fresh pages; only the suffix costs free blocks.
        """
        if rid in self._tables:
            raise ValueError(f"request {rid} already has an allocation")
        prefix_blocks = list(prefix_blocks)
        if self.blocks_for(prefix_len) != len(prefix_blocks):
            raise ValueError(
                f"prefix_len {prefix_len} needs {self.blocks_for(prefix_len)}"
                f" blocks, got {len(prefix_blocks)}")
        if prefix_len >= n_tokens and n_tokens > 0 and prefix_len > 0:
            raise ValueError(
                f"prefix_len {prefix_len} must leave >=1 token to prefill "
                f"(n_tokens={n_tokens})")
        for b in prefix_blocks:
            if self._refcounts.get(b, 0) < 1:
                raise ValueError(f"prefix block {b} is not allocated")
        need = self.blocks_for(n_tokens)
        fresh = need - len(prefix_blocks)
        if fresh < 0:
            raise ValueError(f"{len(prefix_blocks)} prefix blocks exceed the "
                             f"{need} blocks {n_tokens} tokens need")
        if fresh > self.free_blocks:
            raise PoolExhausted(
                f"request {rid}: need {fresh} fresh blocks, "
                f"{self.free_blocks} free")
        for b in prefix_blocks:
            self._refcounts[b] += 1
        popped: List[int] = []
        try:
            for _ in range(fresh):
                popped.append(self._pop_free())
        except PoolExhausted:
            # an injected fault can interrupt the claim mid-loop; roll the
            # partial claim back so the failed alloc leaves no leak behind
            for b in popped:
                self.release(b)
            for b in prefix_blocks:
                self.release(b)
            raise
        blocks = prefix_blocks + popped
        self._tables[rid] = blocks
        self._lengths[rid] = int(n_tokens)
        return list(blocks)

    def append_token(self, rid: int) -> int:
        """Reserve room for one more token; grows the table by one block at
        page boundaries. Returns the token's position (the old length).

        The caller must still `ensure_writable(rid, pos)` before physically
        writing: mid-block positions may land in a shared page."""
        pos = self._lengths[rid]
        if pos == len(self._tables[rid]) * self.block_size:
            if not self._free:
                raise PoolExhausted(
                    f"request {rid}: pool exhausted growing past {pos} tokens")
            self._tables[rid].append(self._pop_free())
        self._lengths[rid] = pos + 1
        return pos

    def pop_token(self, rid: int) -> None:
        """Undo the latest `append_token` — a reservation whose decode step
        never ran (the round raised). Only valid immediately after the
        reservation, before any other table mutation for `rid`: the block a
        boundary-crossing append grew is still private, so releasing it
        frees it."""
        n = self._lengths[rid]
        if n <= 0:
            raise ValueError(f"request {rid} has no token to pop")
        self._lengths[rid] = n - 1
        table = self._tables[rid]
        if len(table) > self.blocks_for(n - 1):
            self.release(table.pop())

    def share(self, block: int) -> None:
        """Take an extra reference on an allocated block (prefix cache /
        another table keeping it alive past its owners)."""
        if self._refcounts.get(block, 0) < 1:
            raise ValueError(f"cannot share unallocated block {block}")
        self._refcounts[block] += 1

    def release(self, block: int) -> bool:
        """Drop one reference; returns the block to the pool when the last
        reference falls. True if the block was actually freed."""
        rc = self._refcounts.get(block, 0)
        if rc < 1:
            raise ValueError(f"release of unallocated block {block}")
        if rc == 1:
            del self._refcounts[block]
            self._free.append(block)
            return True
        self._refcounts[block] = rc - 1
        return False

    def ensure_writable(self, rid: int, pos: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write fork: if the page holding position `pos` of `rid`'s
        table is shared (refcount > 1), replace it with a fresh private page.

        Returns ``(src_block, dst_block)`` when a fork happened — the caller
        must copy the page contents src -> dst in the physical pools — else
        None. Raises `PoolExhausted` when a fork is needed but no page is
        free (caller should evict/preempt and retry)."""
        table = self._tables[rid]
        bi = pos // self.block_size
        if bi >= len(table):
            return None  # append_token will grow with a fresh private page
        src = table[bi]
        if self._refcounts[src] == 1:
            return None
        dst = self._pop_free()
        table[bi] = dst
        self.release(src)  # cannot free: refcount was >= 2
        return src, dst

    def free(self, rid: int) -> int:
        """Drop the request's references. Shared pages survive (prefix cache
        or other tables); returns the count actually returned to the pool."""
        blocks = self._tables.pop(rid)
        del self._lengths[rid]
        return sum(1 for b in blocks if self.release(b))

    # ---------------------------------------------------------- invariants

    def check_invariants(self,
                         extra_refs: Optional[Dict[int, int]] = None) -> None:
        """Every usable block is free xor refcounted (owned by one table,
        shared by several, and/or held by the prefix cache); refcounts equal
        table occurrences plus `extra_refs` (e.g. the prefix cache's, via
        `PrefixCache.block_refs()` — omitted means "no external refs").
        Tables are exactly as long as their lengths require, never repeat a
        block, and never contain the garbage page."""
        owner_counts: Dict[int, int] = {}
        for rid, table in self._tables.items():
            n, used = self._lengths[rid], len(table)
            if used != self.blocks_for(n):
                raise AssertionError(
                    f"request {rid}: {used} blocks for {n} tokens")
            if len(set(table)) != len(table):
                raise AssertionError(f"request {rid} lists a block twice")
            for b in table:
                owner_counts[b] = owner_counts.get(b, 0) + 1
        if GARBAGE_BLOCK in owner_counts or GARBAGE_BLOCK in self._refcounts:
            raise AssertionError("the garbage page was allocated")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate block on the free list")
        refed = set(self._refcounts)
        if free & refed:
            raise AssertionError("a block is both free and refcounted")
        if free | refed != set(range(1, self.num_blocks + 1)):
            raise AssertionError("a block leaked (neither free nor refcounted)")
        for b, rc in self._refcounts.items():
            if rc < 1:
                raise AssertionError(f"block {b} refcounted at {rc}")
        expected = dict(owner_counts)
        for b, n in (extra_refs or {}).items():
            expected[b] = expected.get(b, 0) + n
        if expected != self._refcounts:
            diff = {b: (expected.get(b), self._refcounts.get(b))
                    for b in set(expected) | refed
                    if expected.get(b) != self._refcounts.get(b)}
            raise AssertionError(f"refcount mismatch (expected, actual): {diff}")
