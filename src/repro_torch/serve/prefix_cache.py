"""Radix-tree prefix index: shared prompt prefixes map onto shared KV pages.

The serving engine re-fetches (and re-computes) KV for prompt prefixes that
many requests share — system prompts, few-shot headers. This module
deduplicates them at page granularity: a radix tree keyed by full
token-blocks maps a prompt prefix onto the physical pages already holding
its KV. Because KV rows are position-dependent and every shared prefix
starts at position 0, a page can be reused verbatim by any request whose
prompt starts with the same tokens.

Tree shape: one node per cached page; the edge into a node is the exact
`block_size`-token tuple that page stores, so a root-to-node path spells a
block-aligned token prefix. Matching walks full blocks, then takes the
longest common prefix *within* the first diverging block — the partially
matched page is shared too, and the requester copy-on-write forks it
(`KVPager.ensure_writable`) before writing its own suffix rows mid-block.

Lifecycle: `insert` takes one pager reference per cached page (so pages
survive their owning request), `match` only reads, `evict` drops
least-recently-hit leaf pages whose sole remaining reference is the cache —
the engine calls it under pool pressure before resorting to preemption.

Eviction order is kept in a lazy min-heap of ``(last_hit, seq, block)``
entries (seq = node creation order, the tie-break the old full-scan's
strict-< iteration implied): every touch pushes a fresh entry, pops skip
entries whose node was re-touched, evicted, or is currently an interior
node, and candidates that are merely *ineligible right now* (protected, or
still referenced by a live table) are stashed and re-pushed so they stay
candidates. Reclaim is therefore near-linear in pages actually examined
instead of O(nodes x blocks) rescans — it sits on the pool-pressure
critical path. A parent becomes reclaimable the moment
its last child is evicted, at which point it is pushed back into the heap.

A match never covers a whole prompt: at least one token is always left to
prefill so the engine has logits to sample the first output token from.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.serve.kv_pager import KVPager


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


@dataclasses.dataclass
class PrefixMatch:
    """A prefix-cache lookup result: `blocks` shared pages covering the
    first `n_tokens` prompt tokens (the last page possibly only partially —
    ``n_tokens % block_size`` rows valid)."""

    blocks: List[int]
    n_tokens: int

    @property
    def hit(self) -> bool:
        return self.n_tokens > 0


MISS = PrefixMatch([], 0)


class _Node:
    __slots__ = ("tokens", "block", "parent", "children", "last_hit", "seq")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["_Node"], seq: int):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_hit = 0
        self.seq = seq  # creation order: the LRU heap's tie-break


class PrefixCache:
    """Radix index over the block pool; holds one pager ref per cached page."""

    def __init__(self, pager: KVPager):
        self.pager = pager
        self.block_size = pager.block_size
        self._children: Dict[Tuple[int, ...], _Node] = {}  # root level
        self._by_block: Dict[int, _Node] = {}
        self._heap: List[Tuple[int, int, int]] = []  # (last_hit, seq, block)
        self._seq = 0
        self._clock = 0
        self.lookups = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._by_block)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch(self, node: _Node, now: int) -> None:
        """Stamp a hit and push the node's fresh heap entry (lazy: the
        previous entries go stale and are skipped at pop time)."""
        node.last_hit = now
        heapq.heappush(self._heap, (now, node.seq, node.block))
        if len(self._heap) > max(64, 8 * len(self._by_block)):
            # long-lived processes: compact the stale backlog in one pass
            self._heap = [(n.last_hit, n.seq, n.block)
                          for n in self._by_block.values()]
            heapq.heapify(self._heap)

    # -------------------------------------------------------------- match

    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of `tokens`, capped at ``len(tokens) - 1``
        so the requester always prefills (and gets logits for) at least one
        token. Takes no references — `KVPager.alloc(prefix_blocks=...)`
        does, immediately after, under the same engine step."""
        self.lookups += 1
        toks = [int(t) for t in tokens]
        blk = self.block_size
        now = self._tick()
        blocks: List[int] = []
        covered = 0
        children = self._children
        while True:
            key = tuple(toks[covered:covered + blk])
            node = children.get(key) if len(key) == blk else None
            if node is not None:  # whole block matches: descend
                self._touch(node, now)
                blocks.append(node.block)
                covered += blk
                children = node.children
                continue
            # divergence: share the child page with the longest common
            # prefix inside this block (COW-forked by the requester before
            # it writes its own rows there)
            rest = toks[covered:]
            best, best_n = None, 0
            for child in children.values():
                n = _lcp(child.tokens, rest)
                if n > best_n:
                    best, best_n = child, n
            if best is not None:
                self._touch(best, now)
                blocks.append(best.block)
                covered += best_n
            break
        if covered >= len(toks):
            covered = len(toks) - 1
        while blocks and covered <= (len(blocks) - 1) * blk:
            blocks.pop()  # capping dropped the tail page entirely
        if covered <= 0:
            return MISS
        return PrefixMatch(blocks, covered)

    # ------------------------------------------------------------- insert

    def insert(self, tokens: Sequence[int], table_blocks: Sequence[int]) -> int:
        """Register the *full* blocks of `tokens` (a prompt prefix whose KV
        is final in `table_blocks`, the owning request's table). Pages new
        to the tree gain a cache reference; paths already present are kept
        (the request's duplicate page stays private). Returns pages added."""
        blk = self.block_size
        n_full = len(tokens) // blk
        toks = [int(t) for t in tokens]
        children = self._children
        parent: Optional[_Node] = None
        now = self._tick()
        added = 0
        for i in range(n_full):
            key = tuple(toks[i * blk:(i + 1) * blk])
            node = children.get(key)
            if node is None:
                block = int(table_blocks[i])
                if block in self._by_block:
                    break  # page already backs another path; stop extending
                node = _Node(key, block, parent, self._seq)
                self._seq += 1
                children[key] = node
                self._by_block[block] = node
                self.pager.share(block)
                added += 1
            self._touch(node, now)
            parent = node
            children = node.children
        return added

    # ------------------------------------------------------------- evict

    def evict(self, n_blocks: int,
              protect: FrozenSet[int] = frozenset()) -> List[int]:
        """Free up to `n_blocks` pages: least-recently-hit leaves whose only
        remaining reference is the cache itself (never pages still in a
        live table, never `protect`). Evicting a leaf may expose its parent
        as the next candidate. Returns the freed page ids.

        Heap-driven (see module docstring): pops the LRU candidate instead
        of rescanning every node per freed block; ineligible-for-now
        entries are stashed and re-pushed on exit."""
        evicted: List[int] = []
        stash: List[Tuple[int, int, int]] = []
        heap = self._heap
        while heap and len(evicted) < n_blocks:
            entry = heapq.heappop(heap)
            t, seq, block = entry
            node = self._by_block.get(block)
            if node is None or node.seq != seq or node.last_hit != t:
                continue  # stale: evicted, block reused, or re-touched
            if node.children:
                continue  # interior; re-pushed when its last child goes
            if block in protect or self.pager.refcount(block) != 1:
                stash.append(entry)  # ineligible now, still a candidate
                continue
            siblings = node.parent.children if node.parent else self._children
            del siblings[node.tokens]
            del self._by_block[block]
            self.pager.release(block)
            evicted.append(block)
            self.evictions += 1
            parent = node.parent
            if parent is not None and not parent.children:
                heapq.heappush(heap, (parent.last_hit, parent.seq,
                                      parent.block))
        for entry in stash:
            heapq.heappush(heap, entry)
        return evicted

    # -------------------------------------------------------------- misc

    def block_refs(self) -> Dict[int, int]:
        """Per-page cache references, for `KVPager.check_invariants`."""
        return {b: 1 for b in self._by_block}

    def stats(self) -> Dict[str, int]:
        return {"cached_blocks": len(self._by_block),
                "lookups": self.lookups,
                "evictions": self.evictions}
