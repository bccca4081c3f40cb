"""Continuous-batching request scheduler over the KV block pool.

The policy mirrors the paper's dynamic coroutine scheduler (§III-D): a
*ready request* is a coroutine, the block pool is the context arena, and the
number of requests decoded per round is bounded by the pipeline depth
`core.autotune` solves for the paged decode `CoroSpec` — the serving-side
analogue of "keep exactly enough coroutines in flight to hide latency,
capped by the context the scratchpad can hold".

States:

  WAITING   - queued; admitted when the pool can hold its prompt
  PREFILL   - blocks allocated, prompt KV being written chunk by chunk
  RUNNING   - prefill complete, decoded every round
  FINISHED  - done; block references returned to the pool
  CANCELLED - terminal without completing: caller `cancel`, deadline
              expiry, or the engine aborting a stalled drain
  FAILED    - terminal on error: a poisoned step quarantined the request,
              unresolvable pool pressure, or shed at an overflowing queue

Admission reserves copy-on-write headroom: a prefix match that ends
mid-block will fork the shared partial page on its very first suffix
write, so `admit` requires one spare free block beyond the fresh suffix
blocks whenever ``matched_tokens % block_size != 0`` — without it the
fork's `PoolExhausted` fires after the pages are claimed, when the matched
pages are refcounted >= 2 (unevictable) and there may be nobody left to
preempt. If even reclaiming around the *protected* match pages cannot
cover the need, the match itself is sacrificed: reclaim runs unprotected,
the prompt is re-matched against whatever survived, and admission retries
as a (partial or full) miss.

Rounds mix work under a **token budget** (`plan_round`): every running
request decodes one token (decode is never starved by prefill), and the
leftover budget is spent on prefill chunks of admitted-but-unfinished
prompts, oldest admission first. A long prompt therefore trickles through
several rounds instead of stalling every in-flight decode for one
monolithic prefill — the chunks and the decode steps share the same paged
pipeline and the same rounds.

Pool pressure resolves in two stages: first `reclaim` (the engine's hook
that evicts cache-only pages from the prefix index, LRU), then preemption —
the *latest-admitted* other in-flight request is evicted: its page
references are dropped and it re-queues at the front of the waiting line,
keeping everything it has generated so far (recompute-on-readmit — which,
with the prefix cache, usually turns into a cheap prefix hit on its own
surviving pages). Evicting the newest request never starves the oldest, so
every admitted request eventually finishes as long as the pool can hold a
single maximal request.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Callable, Deque, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.obs import trace as obs_trace
from repro_torch.serve.faults import NULL_INJECTOR
from repro_torch.serve.kv_pager import KVPager, PoolExhausted
from repro_torch.serve.prefix_cache import MISS, PrefixMatch


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"


TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.CANCELLED,
                             RequestState.FAILED})


@dataclasses.dataclass
class Request:
    """One generation request flowing through the engine."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    state: RequestState = RequestState.WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    kv_len: int = 0                  # tokens with pool room reserved
    prefill_pos: int = 0             # context tokens whose KV is written
    matched_len: int = 0             # prefix-cache tokens reused (last admit)
    preemptions: int = 0
    admit_seq: int = -1              # order of the (latest) admission
    submit_s: float = 0.0            # wall clock at submit (engine stamps)
    first_token_s: Optional[float] = None
    last_emit_s: Optional[float] = None
    deadline_s: Optional[float] = None  # absolute perf_counter deadline
    stalls: int = 0                  # unresolvable-pressure requeues
    fault_count: int = 0             # consecutive failed steps (engine)
    error: Optional[str] = None      # what quarantined it (FAILED only)
    finish_reason: Optional[str] = None  # complete / cancelled / deadline /
    #                                      shed / stalled / fault / ...

    @property
    def context(self) -> List[int]:
        """Tokens to prefill on (re-)admission: prompt + generated so far."""
        return self.prompt + self.generated

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit -> first token wall time (None until the first token)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s


# reclaim hook: (blocks_needed, protect) -> blocks actually freed
ReclaimFn = Callable[[int, FrozenSet[int]], int]
# prefix lookup hook: context tokens -> PrefixMatch
MatchFn = Callable[[Sequence[int]], PrefixMatch]


class ContinuousBatchingScheduler:
    """Admit / evict / preempt on pool pressure; assemble budgeted rounds."""

    def __init__(self, pager: KVPager, max_in_flight: int, *,
                 token_budget: Optional[int] = None,
                 reclaim: Optional[ReclaimFn] = None,
                 faults=NULL_INJECTOR):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        self.pager = pager
        self.max_in_flight = int(max_in_flight)
        self.token_budget = token_budget
        self.reclaim = reclaim
        self.faults = faults  # serve.faults hook ("preempt_refuse" site)
        self.waiting: Deque[Request] = deque()
        self.prefilling: List[Request] = []
        self.running: List[Request] = []
        self.preemptions = 0
        self._admit_seq = 0

    # ------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    def in_flight(self) -> int:
        return len(self.prefilling) + len(self.running)

    # ---------------------------------------------------------- admission

    def _blocks_needed(self, ctxt: Sequence[int], m: PrefixMatch) -> int:
        """Free blocks an admission must see: the fresh suffix blocks, plus
        one spare when the match ends mid-block — the request's first
        suffix write copy-on-write forks that shared partial page, and the
        fork must not be left to fail *after* the pages are claimed (the
        matched page is then refcounted >= 2, hence unevictable, and with
        no other in-flight request there is nobody to preempt — the
        crash this rule prevents)."""
        fresh = self.pager.blocks_for(len(ctxt)) - len(m.blocks)
        if m.n_tokens % self.pager.block_size:
            fresh += 1
        return fresh

    def admit(self, match: Optional[MatchFn] = None) -> List[Request]:
        """Move waiting requests to PREFILL while the round has slots and
        the pool can hold their context. `match` (the engine's prefix-cache
        lookup) lets an admission reference already-resident prefix pages —
        only the suffix costs fresh blocks, and only the suffix is
        prefilled. FIFO: admission stops at the first request that does not
        fit even after reclaiming cache-only pages, so a large head request
        cannot be starved by small ones slipping past it."""
        admitted: List[Request] = []
        while self.waiting and self.in_flight() < self.max_in_flight:
            req = self.waiting[0]
            ctxt = req.context
            m = match(ctxt) if match is not None else MISS
            need = self._blocks_needed(ctxt, m)
            if need > self.pager.free_blocks and self.reclaim is not None:
                self.reclaim(need - self.pager.free_blocks,
                             frozenset(m.blocks))
                if need > self.pager.free_blocks and m.hit:
                    # the only reclaimable pages may be the protected match
                    # itself: give the match up, reclaim unprotected, and
                    # re-match against whatever survived
                    if self.reclaim(need - self.pager.free_blocks,
                                    frozenset()):
                        m = match(ctxt) if match is not None else MISS
                        need = self._blocks_needed(ctxt, m)
            if need > self.pager.free_blocks:
                break
            try:
                self.pager.alloc(req.rid, len(ctxt),
                                 prefix_blocks=m.blocks, prefix_len=m.n_tokens)
            except PoolExhausted:
                break  # injected fault mid-claim; retry next round
            self.waiting.popleft()
            req.kv_len = len(ctxt)
            req.prefill_pos = m.n_tokens
            req.matched_len = m.n_tokens
            req.state = RequestState.PREFILL
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.prefilling.append(req)
            admitted.append(req)
        return admitted

    # --------------------------------------------------------- preemption

    def _preempt_one(self, protect: Request) -> bool:
        """Evict the latest-admitted in-flight request other than `protect`."""
        if self.faults.fire("preempt_refuse", protect=protect.rid):
            return False  # injected: the victim is unpreemptable right now
        victims = [r for r in self.prefilling + self.running if r is not protect]
        if not victims:
            return False
        victim = max(victims, key=lambda r: r.admit_seq)
        # preemption is rare enough to fetch the tracer per event
        obs_trace.get_tracer().instant("preempt", rid=victim.rid,
                                       kv_len=victim.kv_len,
                                       state=victim.state.value)
        victim.preemptions += 1
        self.preemptions += 1
        self.requeue(victim)
        return True

    def requeue(self, req: Request) -> None:
        """Push an in-flight request back to the head of the waiting line
        (recompute-on-readmit): drop its page references and reset its
        prefill progress; everything generated so far is kept. Used by
        preemption and by the engine's stall path (unresolvable pressure)."""
        if self.pager.owns(req.rid):
            self.pager.free(req.rid)
        req.kv_len = 0
        req.prefill_pos = 0
        req.state = RequestState.WAITING
        if req in self.running:
            self.running.remove(req)
        elif req in self.prefilling:
            self.prefilling.remove(req)
        if req not in self.waiting:
            self.waiting.appendleft(req)

    def unreserve(self, req: Request) -> None:
        """Roll back `reserve_decode_slot` for a decode step that never
        executed (the round raised after reservations were made)."""
        if req.state is RequestState.RUNNING and self.pager.owns(req.rid):
            self.pager.pop_token(req.rid)

    def _under_pressure(self, req: Request, fn):
        """Run a pager operation, resolving `PoolExhausted` by reclaiming a
        cache-only page, then by preempting the newest other request; raises
        only when `req` *alone* overflows the pool. A caller iterating a
        round must re-check each request's state afterwards: resolving
        pressure for an early request may evict a later one."""
        while True:
            try:
                return fn()
            except PoolExhausted:
                if self.reclaim is not None and self.reclaim(1, frozenset()):
                    continue
                if not self._preempt_one(req):
                    raise

    def reserve_decode_slot(self, req: Request) -> int:
        """Reserve pool room for `req`'s next token; returns its position."""
        return self._under_pressure(
            req, lambda: self.pager.append_token(req.rid))

    def make_writable(self, req: Request, pos: int):
        """Copy-on-write guard before writing the KV row at `pos`: forks the
        containing page if it is shared. Returns the pager's (src, dst) copy
        order, or None."""
        return self._under_pressure(
            req, lambda: self.pager.ensure_writable(req.rid, pos))

    # ------------------------------------------------------------- rounds

    def plan_round(self, chunk: Optional[int]) -> Tuple[
            List[Request], List[Tuple[Request, int]]]:
        """One round's work under the token budget: every RUNNING request
        decodes (1 token each, never starved), then the leftover budget is
        spent on prefill chunks of at most `chunk` tokens (None: the whole
        remaining prompt), oldest admission first."""
        decodes = sorted(self.running, key=lambda r: r.admit_seq)
        left: Optional[int] = None
        if self.token_budget is not None:
            left = max(self.token_budget - len(decodes), 0)
        plans: List[Tuple[Request, int]] = []
        for req in sorted(self.prefilling, key=lambda r: r.admit_seq):
            if left is not None and left <= 0:
                break
            n = len(req.context) - req.prefill_pos
            if chunk is not None:
                n = min(n, chunk)
            if left is not None:
                n = min(n, left)
            if n > 0:
                plans.append((req, n))
                if left is not None:
                    left -= n
        return decodes, plans

    def round(self) -> List[Request]:
        """The requests decoding this round, oldest admission first."""
        return sorted(self.running, key=lambda r: r.admit_seq)

    def promote(self, req: Request) -> None:
        """Prefill complete: the request decodes from the next round on."""
        self.prefilling.remove(req)
        req.state = RequestState.RUNNING
        self.running.append(req)

    def finish(self, req: Request) -> None:
        self.retire(req, RequestState.FINISHED)

    def retire(self, req: Request,
               state: RequestState = RequestState.FINISHED) -> None:
        """Terminal transition from *any* queue (or none — a shed request
        never entered one): drop the request's page references and remove
        it from whichever collection holds it. `state` must be terminal."""
        if state not in TERMINAL_STATES:
            raise ValueError(f"retire needs a terminal state, got {state}")
        if self.pager.owns(req.rid):
            self.pager.free(req.rid)
        req.state = state
        if req in self.running:
            self.running.remove(req)
        elif req in self.prefilling:
            self.prefilling.remove(req)
        elif req in self.waiting:
            self.waiting.remove(req)
