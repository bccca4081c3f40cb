"""Paged-KV continuous-batching serving engine.

Every round the scheduler plans work under a token budget: all running
requests decode one token through `models.lm.decode_step_paged`
(per-request ragged positions, one fixed round width, KV pools written in
place), and the leftover budget drives **chunked prefill** — admitted
prompts trickle through `models.lm.prefill_chunk_paged` a fixed-size chunk
at a time, writing KV directly into their pages. The round width is the
pipeline depth `core.autotune` solves for the paged decode `CoroSpec`: the
scheduler keeps as many request-coroutines in flight as the tuned pipeline
keeps page-tiles in flight.

Shared prompt prefixes dedup through the radix **prefix cache**
(`serve/prefix_cache.py`): admission looks the prompt up, already-resident
pages are refcounted into the new request's table, and only the suffix is
prefilled. Pages a request would write mid-block are copy-on-write forked
first (`KVPager.ensure_writable` + a physical page copy here). Under pool
pressure the engine reclaims least-recently-hit cache-only pages before the
scheduler resorts to preemption.

The decode step's attention runs through the paged flash-decode kernel
(`kernels/decode_attention`): its CUDA kernel when the engine lives on a
GPU, its plain PyTorch version on the CPU. The engine runs on the GPU unless
the caller passes ``device="cpu"``; with no CUDA device it raises instead of
quietly running on the CPU.

Because freed pages are reused immediately, the aggregate KV served over a
workload routinely exceeds what the same HBM held as a dense
``[batch, max_len]`` cache — `stats()["kv_oversubscription"]` reports the
ratio.

Failure model: every submitted request reaches a
terminal state — FINISHED, CANCELLED, or FAILED — no matter what the pool,
the steps, or the injected chaos (`serve/faults.py`) do. Per-request
deadlines (`deadline_s`) cancel expired requests at round boundaries;
`cancel(rid)` does the same on demand; a bounded admission queue
(`max_queue`) sheds overflow at submit time (FAILED, reason "shed").
`step_round` is exception-safe: a step that raises marks its requests
faulted and retries them, quarantining any request whose consecutive-fault
count exceeds `max_request_faults` (pages freed, trace span closed,
`on_finish` invoked, state FAILED); unresolvable pool pressure
(`PoolExhausted` escaping reclaim + preemption) requeues the request at
the head of the waiting line and quarantines it after `max_stalls`
attempts. `run()` never raises on a wedged workload: after `max_rounds`
total or `max_idle_rounds` rounds of zero progress it cancels the
remainder (reason "stalled") and returns partial stats with full
stalled/failed/shed/deadline accounting.

Observability: every engine instance owns one
`obs.metrics` registry — the prefix/COW counters and the token-latency /
TTFT / TBT histograms live there, and `stats()` is a read-time view over
it, not a parallel dict. The engine also feeds the process tracer
(`obs.trace`): per-round / decode-round / prefill-chunk spans, an async
``request`` span per request lifetime, a ``pipeline:paged_decode`` span per
decode round (depth / n_tiles / context-bytes attributes), and instant
events for COW forks and cache evictions (preemptions are emitted by the
scheduler). Both degrade to module-level null objects under
``REPRO_TELEMETRY=0`` — no per-call branching in the round loop.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, FrozenSet, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import autotune, guard
from repro_torch.core.machine import get_machine
from repro_torch.kernels.decode_attention.decode_attention import paged_decode_spec
from repro_torch.models import build_model
from repro_torch.models.params import torch_dtype
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import latency_report  # noqa: F401  (re-export)
from repro_torch.serve.faults import NULL_INJECTOR, FaultInjector
from repro_torch.serve.kv_pager import KVPager, PoolExhausted
from repro_torch.serve.prefill import ChunkedPrefiller
from repro_torch.serve.prefix_cache import MISS, PrefixCache, PrefixMatch
from repro_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    RequestState,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. Never falls back to the CPU: asking for CUDA (explicitly or by
    default) where there is none raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless asked for the "
            "CPU (pass device=\"cpu\", or --device cpu)")
    return dev


class PagedServingEngine:
    """Continuous batching over a paged KV pool for one model instance."""

    def __init__(self, cfg: ArchConfig, *,
                 block_size: int = 16, num_blocks: int = 64,
                 max_in_flight: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: int = 32,
                 token_budget: Optional[int] = None,
                 params: Optional[Any] = None, seed: int = 0,
                 on_token: Optional[Callable[[Request, int], None]] = None,
                 on_finish: Optional[Callable[[Request], None]] = None,
                 deadline_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 max_stalls: int = 8,
                 max_request_faults: int = 3,
                 faults: Optional[FaultInjector] = None,
                 device=None):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        if not self.model.supports_paged_decode():
            raise ValueError(
                f"arch {cfg.name!r} (family={cfg.family}, sliding_window="
                f"{cfg.sliding_window}, moe={cfg.moe}) is not on this "
                "package's paged path: it serves plain-attention archs with "
                "a dense FFN")
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            params = self.model.init(gen, self.device)
        self.params = params
        self.faults = faults if faults is not None else NULL_INJECTOR
        self.deadline_s = deadline_s
        self.max_queue = max_queue
        self.max_stalls = int(max_stalls)
        self.max_request_faults = int(max_request_faults)
        self.pager = KVPager(num_blocks, block_size, faults=self.faults)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.pager) if prefix_cache else None)
        kh, hd, g = cfg.kv_heads, cfg.resolved_head_dim, cfg.n_heads // cfg.kv_heads

        # scheduler <-> autotune coupling: in-flight requests per round =
        # the solved pipeline depth of the paged decode spec (clamped to 2+)
        dtype = torch_dtype(cfg.dtype)
        spec = paged_decode_spec(block_size, kh, g, hd, dtype,
                                 max_blocks=max(num_blocks, 1))
        self.solved_depth = autotune.choose_depth(
            spec.profile(), kernel="paged_decode", vars=spec.all_vars())
        self._pipeline_ctx_bytes = spec.context_bytes(self.solved_depth)
        # a round can't usefully exceed one block-owning request per block
        self.round_width = int(max_in_flight
                               or min(max(2, self.solved_depth), num_blocks))
        self.prefill_chunk = int(prefill_chunk)
        # budget: every running request decodes, plus one chunk's worth of
        # prefill trickles alongside — decode is never starved, prefill
        # never stalls a round for a whole prompt
        self.token_budget = int(token_budget
                                or self.round_width + self.prefill_chunk)
        self.scheduler = ContinuousBatchingScheduler(
            self.pager, self.round_width,
            token_budget=self.token_budget, reclaim=self._reclaim,
            faults=self.faults)
        self.prefiller = ChunkedPrefiller(self.model, block_size, self.device)

        # [L, NB+1, blk, KH, D], written in place by every step
        shape = (cfg.n_layers, self.pager.physical_blocks, block_size, kh, hd)
        self.k_pools = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pools = torch.zeros(shape, dtype=dtype, device=self.device)

        self.on_token = on_token
        self.on_finish = on_finish
        self._requests: Dict[int, Request] = {}   # live (non-terminal) only
        self._done: Dict[int, Request] = {}       # terminal, any reason
        self._next_rid = 0
        # the first decode round pays the kernel build and load: keep its
        # wall clock out of the transfer-telemetry feedback store
        self._decode_fresh = True
        self._tw_hw = 1    # padded-table high-water mark
        self.rounds = 0
        self.decode_rounds = 0                  # decode steps that ran
        self.finished: List[Request] = []       # FINISHED (completed) only

        # one registry per engine instance (two engines in one process must
        # not mix counters); `stats()` is a view over it. The
        # tracer is fetched once: the round loop calls through it with no
        # enabled() branching (null objects under REPRO_TELEMETRY=0).
        self.metrics = obs_metrics.new_registry()
        self.tracer = obs_trace.get_tracer()
        m = self.metrics
        self._c_prefix_hits = m.counter("serve.prefix_hits")
        self._c_prefix_tokens = m.counter("serve.prefix_tokens")
        self._c_blocks_shared = m.counter("serve.blocks_shared")
        self._c_cow_forks = m.counter("serve.cow_forks")
        self._c_prefill_s = m.counter("serve.prefill_s")
        self._c_decode_s = m.counter("serve.decode_s")
        self._h_token = m.histogram("serve.token_latency_s")
        self._h_tbt = m.histogram("serve.tbt_s")   # inter-token gaps
        self._h_ttft = m.histogram("serve.ttft_s")
        # failure-model counters: terminal accounting in stats()
        # is derived from the requests themselves (robust under
        # REPRO_TELEMETRY=0); these feed the scrapeable registry
        self._c_cancelled = m.counter("serve.cancelled")
        self._c_failed = m.counter("serve.failed")
        self._c_shed = m.counter("serve.shed")
        self._c_deadline = m.counter("serve.deadline_expired")
        self._c_stalls = m.counter("serve.stalls")
        self._c_step_faults = m.counter("serve.step_faults")

    # ------------------------------------------------- registry views
    #
    # read-only aliases of the registry metrics, kept so callers (tests,
    # notebooks) that peeked at the old plain attributes still work

    @property
    def prefix_hits(self) -> int:
        return int(self._c_prefix_hits.value)

    @property
    def prefix_tokens(self) -> int:
        return int(self._c_prefix_tokens.value)

    @property
    def blocks_shared(self) -> int:
        return int(self._c_blocks_shared.value)

    @property
    def cow_forks(self) -> int:
        return int(self._c_cow_forks.value)

    @property
    def prefill_s(self) -> float:
        return self._c_prefill_s.value

    @property
    def decode_s(self) -> float:
        return self._c_decode_s.value

    @property
    def token_latencies_s(self) -> List[float]:
        return self._h_token.samples

    @property
    def tbt_s(self) -> List[float]:
        return self._h_tbt.samples

    # -------------------------------------------------------------- intake

    def submit(self, prompt_tokens, max_new_tokens: int,
               deadline_s: Optional[float] = None) -> int:
        """Queue one request. Returns its id; results stream via callbacks
        and land on `request(rid).generated`.

        `deadline_s` (relative seconds; the engine default applies when
        None) bounds the request's wall-clock lifetime — past it, the
        request is CANCELLED at the next round boundary. When the waiting
        queue is full (`max_queue`), the request is **shed**: it still gets
        an id, but it is immediately terminal (FAILED, reason "shed") and
        `on_finish` fires — the caller distinguishes by state, not by
        exception, so a bursty client never crashes the intake path."""
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        max_total = len(prompt) + max_new_tokens
        if self.pager.blocks_for(max_total) > self.pager.num_blocks:
            raise ValueError(
                f"request needs {self.pager.blocks_for(max_total)} blocks at "
                f"full length; pool has {self.pager.num_blocks}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens))
        req.submit_s = time.perf_counter()
        rel = deadline_s if deadline_s is not None else self.deadline_s
        if rel is not None:
            req.deadline_s = req.submit_s + float(rel)
        self._requests[rid] = req
        self.tracer.begin_async("request", rid,
                                tid=obs_trace.TID_REQUEST_BASE + rid,
                                prompt_len=len(prompt),
                                max_new_tokens=int(max_new_tokens))
        if (self.max_queue is not None
                and len(self.scheduler.waiting) >= self.max_queue):
            self._c_shed.inc()
            self.tracer.instant("shed", rid=rid,
                                queued=len(self.scheduler.waiting))
            self._retire(req, RequestState.FAILED, "shed")
            return rid
        self.scheduler.submit(req)
        return rid

    def request(self, rid: int) -> Request:
        live = self._requests.get(rid)
        return live if live is not None else self._done[rid]

    def cancel(self, rid: int, *, reason: str = "cancelled") -> bool:
        """Cancel a live request: pages freed, span closed, `on_finish`
        invoked, terminal state CANCELLED. False if the id is unknown or
        the request is already terminal (cancel is idempotent)."""
        req = self._requests.get(rid)
        if req is None:
            return False
        self._c_cancelled.inc()
        if reason == "deadline":
            self._c_deadline.inc()
        self.tracer.instant("cancel", rid=rid, reason=reason,
                            state=req.state.value)
        self._retire(req, RequestState.CANCELLED, reason)
        return True

    # --------------------------------------------------- terminal plumbing

    def _retire(self, req: Request, state: RequestState, reason: str,
                error: Optional[str] = None) -> None:
        """The one terminal transition every non-complete path routes
        through: dequeue + free pages, stamp the reason, close the request
        trace span, move the request to the retired map, fire
        `on_finish`. Idempotent — a request already terminal is left be."""
        if req.rid in self._done:
            return
        self.scheduler.retire(req, state)
        req.finish_reason = reason
        if error is not None:
            req.error = error
        self._requests.pop(req.rid, None)
        self._done[req.rid] = req
        self.tracer.end_async("request", req.rid,
                              tid=obs_trace.TID_REQUEST_BASE + req.rid,
                              generated=len(req.generated),
                              state=state.value, reason=reason)
        if self.on_finish:
            self.on_finish(req)

    def _quarantine(self, req: Request, err: BaseException, *,
                    reason: str = "fault") -> None:
        """Poisoned request: isolate it so the engine (and every other
        request) survives. Pages freed, span closed, `on_finish` fired."""
        self._c_failed.inc()
        self.tracer.instant("quarantine", rid=req.rid, reason=reason,
                            error=type(err).__name__)
        self._retire(req, RequestState.FAILED, reason,
                     error=f"{type(err).__name__}: {err}")

    def _note_fault(self, req: Request, err: BaseException) -> None:
        """A step serving `req` raised. Transient faults retry (the request
        stays where it is); `max_request_faults` consecutive failures
        quarantine it. The counter resets on any successful step."""
        req.fault_count += 1
        self._c_step_faults.inc()
        self.tracer.instant("step_fault", rid=req.rid,
                            count=req.fault_count,
                            error=type(err).__name__)
        if req.fault_count > self.max_request_faults:
            self._quarantine(req, err)

    def _stall(self, req: Request, err: BaseException) -> None:
        """Pool pressure that reclaim + preemption could not resolve for
        `req`: requeue it (recompute-on-readmit) and count the stall;
        `max_stalls` of them quarantine it as unservable right now."""
        req.stalls += 1
        self._c_stalls.inc()
        self.tracer.instant("stall", rid=req.rid, stalls=req.stalls)
        if req.stalls > self.max_stalls:
            self._quarantine(req, err, reason="pool_exhausted")
        else:
            self.scheduler.requeue(req)

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()
        expired = [r for r in self._requests.values()
                   if r.deadline_s is not None and now >= r.deadline_s]
        for req in expired:
            self.cancel(req.rid, reason="deadline")

    # ------------------------------------------------------ prefix plumbing

    def _match(self, tokens) -> PrefixMatch:
        if self.prefix_cache is None:
            return MISS
        with self.tracer.span("prefix_lookup", n_tokens=len(tokens)):
            return self.prefix_cache.match(tokens)

    def _reclaim(self, n_blocks: int, protect: FrozenSet[int]) -> int:
        """Scheduler pressure hook: drop LRU cache-only pages."""
        if self.faults.fire("reclaim_refuse", requested=n_blocks):
            return 0  # injected: every cold page is pinned right now
        if self.prefix_cache is None:
            return 0
        freed = len(self.prefix_cache.evict(n_blocks, protect))
        if freed:
            self.tracer.instant("cache_evict", requested=n_blocks,
                                freed=freed)
        return freed

    def _copy_page(self, src: int, dst: int) -> None:
        """Materialise a copy-on-write fork in the physical pools (every
        layer's page `src` copied into page `dst`, in place)."""
        self.k_pools[:, dst] = self.k_pools[:, src]
        self.v_pools[:, dst] = self.v_pools[:, src]
        self._c_cow_forks.inc()
        self.tracer.instant("cow_fork", src=src, dst=dst)

    def _make_writable(self, req: Request, pos: int) -> None:
        copy = self.scheduler.make_writable(req, pos)
        if copy is not None:
            self._copy_page(*copy)

    # ------------------------------------------------------------- prefill

    def _prefill_chunk_step(self, req: Request, n: int) -> None:
        """Run one `n`-token chunk of `req`'s prefill; on the last chunk,
        emit the first generated token and promote (or finish)."""
        ctxt = req.context
        start = req.prefill_pos
        n = min(n, len(ctxt) - start)
        if n <= 0:
            return
        self.faults.check("prefill", rid=req.rid, start=start, n=n)
        guard.check_injected("paged_prefill_chunk", self.faults,
                             rid=req.rid, start=start, n=n)
        # the chunk's first page may be shared (a partial-block prefix hit):
        # fork it before writing rows into it
        self._make_writable(req, start)
        if req.state is not RequestState.PREFILL:
            return  # the fork's pressure resolution preempted this request
        tw = self._table_width()
        table = self.pager.padded_table(req.rid, tw)
        t0 = time.perf_counter()
        with self.tracer.span("prefill_chunk", rid=req.rid, start=start, n=n):
            logits, self.k_pools, self.v_pools, _ = self.prefiller.run_chunk(
                self.params, self.k_pools, self.v_pools,
                ctxt[start:start + n], table, start, n)
        self._c_prefill_s.inc(time.perf_counter() - t0)
        # the always-on numerics scan: a non-finite chunk raises before
        # prefill_pos advances, so the chunk re-runs on retry (its KV rows
        # rewrite idempotently; the pools are already written)
        nerr = guard.scan_output("paged_prefill_chunk", logits)
        if nerr is not None:
            raise nerr
        req.prefill_pos = start + n
        if self.prefix_cache is not None:
            self.prefix_cache.insert(ctxt[:req.prefill_pos],
                                     self.pager.block_table(req.rid))
        if req.prefill_pos >= len(ctxt):
            first = int(torch.argmax(logits[0]))
            self._emit(req, first)
            if req.done:  # max_new_tokens == 1: satisfied by this token
                self._finish(req)
            else:
                self.scheduler.promote(req)

    def _emit(self, req: Request, token: int) -> None:
        now = time.perf_counter()
        if req.first_token_s is None:
            req.first_token_s = now
        elif req.last_emit_s is not None:
            self._h_tbt.observe(now - req.last_emit_s)
        req.last_emit_s = now
        req.generated.append(token)
        if self.on_token:
            self.on_token(req, token)

    def _finish(self, req: Request) -> None:
        """Retire one completed request: free its pages, close its
        lifecycle span, and fold its TTFT into the registry histogram."""
        if req.rid in self._done:
            return  # a callback already cancelled it mid-step
        self.scheduler.finish(req)
        req.finish_reason = "complete"
        self.finished.append(req)
        self._requests.pop(req.rid, None)
        self._done[req.rid] = req
        if req.ttft_s is not None:
            self._h_ttft.observe(req.ttft_s)
        self.tracer.end_async("request", req.rid,
                              tid=obs_trace.TID_REQUEST_BASE + req.rid,
                              generated=len(req.generated),
                              preemptions=req.preemptions)
        if self.on_finish:
            self.on_finish(req)

    # -------------------------------------------------------------- decode

    def _decode_step(self, tokens, tables, lengths):
        """One batched decode step on the engine's device: the next greedy
        token of every row, as a host array."""
        dev = self.device
        logits, self.k_pools, self.v_pools = self.model.decode_step_paged(
            self.params, self.k_pools, self.v_pools,
            torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev),
            {"tokens": torch.from_numpy(tokens).to(dev)})
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    def _table_width(self) -> int:
        """Block-table width: every request's table padded to the worst
        case any **live** request can reach, tracked as a high-water mark
        so the width is stable across the rounds of one workload (the same
        widths as the reference package, whose compiled steps key on it).
        Terminal requests move out of `_requests`, so one long retired
        request does not pin the width forever; the mark only drops once
        the live need falls to half of it."""
        need = max((self.pager.blocks_for(len(r.prompt) + r.max_new_tokens)
                    for r in self._requests.values()), default=1)
        need = max(need, 1)
        if need > self._tw_hw:
            self._tw_hw = need
        elif need <= self._tw_hw // 2:
            self._tw_hw = need
        return self._tw_hw

    def _decode_round(self, active: List[Request]) -> int:
        """Decode one token for every (still-)running request in `active`."""
        # reserve pool room for each request's next token; reserving may
        # preempt later-admitted members of this same round, and writing
        # mid-block may copy-on-write fork a page the prefix cache shares.
        # Pressure neither reclaim nor preemption can resolve stalls the
        # request (requeue, bounded retries) instead of crashing the round.
        writable: List[Request] = []
        for req in active:
            if req.state is not RequestState.RUNNING:
                continue  # preempted by an earlier reservation
            try:
                pos = self.scheduler.reserve_decode_slot(req)
                if req.state is RequestState.RUNNING:
                    self._make_writable(req, pos)
            except PoolExhausted as e:
                self._stall(req, e)
                continue
            writable.append(req)
        writable = [r for r in writable if r.state is RequestState.RUNNING]
        if not writable:
            return 0

        width = self.round_width
        tw = self._table_width()
        tokens = np.zeros((width, 1), np.int32)
        tables = np.zeros((width, tw), np.int32)   # garbage page 0 padding
        lengths = np.zeros((width,), np.int32)
        for i, req in enumerate(writable):
            tokens[i, 0] = req.generated[-1]
            tables[i] = self.pager.padded_table(req.rid, tw)
            # pager length already counts the reserved slot; the model wants
            # the pre-write count (the new row's position)
            lengths[i] = self.pager.length(req.rid) - 1

        t0 = time.perf_counter()
        try:
            self.faults.check("decode", round=self.rounds,
                              width=len(writable))
            # kernel-site faults fire BEFORE the step touches the pools, so
            # an injected fault never leaves a half-written step; a typed
            # SubstrateError here rides the same rollback + _note_fault
            # path as any other step fault
            guard.check_injected("paged_decode_round", self.faults,
                                 round=self.rounds, width=len(writable))
            with self.tracer.span("decode_round", width=len(writable),
                                  table_width=tw):
                nxt = self._decode_step(tokens, tables, lengths)
        except Exception as e:
            # the batched step raised: roll the reservations back and let
            # every member retry next round. A step that failed part-way may
            # already have written some layers' KV rows at these positions;
            # the retry decodes the same token at the same position and
            # rewrites those rows with the same values, so nothing stale is
            # ever read. Attribution inside a batch is ambiguous, so blame
            # is shared and `max_request_faults` consecutive failures
            # quarantine
            for req in writable:
                self.scheduler.unreserve(req)
            for req in writable:
                self._note_fault(req, e)
            return 0
        dt = time.perf_counter() - t0
        self._c_decode_s.inc(dt)
        self.decode_rounds += 1

        # always-on transfer telemetry: every decode round feeds the
        # (machine, kernel) store the depth solver reads — wall clock over
        # the KV page-tiles this round actually attended. The same interval
        # is the round's `pipeline:paged_decode` span on the tracer, with
        # depth / n_tiles / context-bytes attributes.
        tiles = sum(self.pager.blocks_for(int(n) + 1)
                    for n in (lengths[i] for i in range(len(writable))))
        end_us = self.tracer.now_us()
        self.tracer.complete("pipeline:paged_decode", end_us - dt * 1e6,
                             dt * 1e6, tid=obs_trace.TID_KERNEL,
                             depth=self.solved_depth, n_tiles=tiles,
                             context_bytes=self._pipeline_ctx_bytes,
                             warmup=self._decode_fresh)
        if self._decode_fresh:
            self._decode_fresh = False  # round paid the build; don't record
        elif autotune.telemetry_enabled() and tiles:
            autotune.record_transfer("paged_decode", dt / tiles)

        for i, req in enumerate(writable):
            if req.state is not RequestState.RUNNING:
                continue  # a callback cancelled it mid-round
            req.fault_count = 0  # a successful step clears shared blame
            req.kv_len = self.pager.length(req.rid)
            self._emit(req, int(nxt[i]))
            self._h_token.observe(dt)
            if req.done:
                self._finish(req)
        return len(writable)

    # --------------------------------------------------------------- round

    def step_round(self) -> int:
        """One budgeted scheduler round: expire deadlines, admit (with
        prefix lookup), decode one token for every running request, then
        spend the leftover budget on prefill chunks. Exception-safe: a
        failing step faults (and eventually quarantines) the requests it
        served, never the engine. Returns tokens emitted this round."""
        with self.tracer.span("round", n=self.rounds):
            self._expire_deadlines()
            spike = self.faults.latency_spike("latency")
            if spike > 0.0:
                self.tracer.instant("latency_spike",
                                    sleep_ms=round(spike * 1e3, 3))
                time.sleep(spike)
            for req in self.scheduler.admit(match=self._match):
                self.tracer.instant("admit", rid=req.rid,
                                    matched=req.matched_len,
                                    context=len(req.context))
                if req.matched_len > 0:
                    self._c_prefix_hits.inc()
                    self._c_prefix_tokens.inc(req.matched_len)
                    self._c_blocks_shared.inc(
                        self.pager.blocks_for(req.matched_len))

            decodes, plans = self.scheduler.plan_round(self.prefill_chunk)
            emitted = self._decode_round(decodes)
            for req, n in plans:
                if req.state is not RequestState.PREFILL:
                    continue  # preempted resolving an earlier req's pressure
                before = len(req.generated)
                try:
                    self._prefill_chunk_step(req, n)
                    req.fault_count = 0
                except PoolExhausted as e:
                    self._stall(req, e)
                except Exception as e:
                    self._note_fault(req, e)
                emitted += len(req.generated) - before
            self.rounds += 1
            return emitted

    # ----------------------------------------------------------------- run

    def run(self, max_rounds: int = 100_000, *,
            max_idle_rounds: int = 64) -> Dict[str, Any]:
        """Serve until every submitted request reaches a terminal state.

        Never raises on a wedged workload: past `max_rounds` total — or
        `max_idle_rounds` consecutive rounds with nothing in flight and
        nothing admitted (a head request the pool can never hold) — the
        remaining requests are cancelled (reason "stalled") and the stats
        of the work that *did* complete are returned, with the stall/fail
        accounting alongside."""
        rounds = 0
        idle = 0
        while self.scheduler.has_work():
            if rounds >= max_rounds or idle >= max_idle_rounds:
                for req in list(self._requests.values()):
                    self.cancel(req.rid, reason="stalled")
                self.tracer.instant("run_stalled", rounds=rounds, idle=idle)
                break
            emitted = self.step_round()
            rounds += 1
            if emitted == 0 and self.scheduler.in_flight() == 0:
                idle += 1
            else:
                idle = 0
        self.pager.check_invariants(
            self.prefix_cache.block_refs() if self.prefix_cache else None)
        return self.stats()

    def stats(self) -> Dict[str, Any]:
        """Aggregate serving stats — a read-time VIEW over the engine's
        metrics registry (plus pager/scheduler state), not a parallel
        store. `metrics.snapshot()` / `metrics.prometheus_text()` expose
        the same registry for scraping."""
        decoded = self._h_token.count
        agg_kv = sum(len(r.prompt) + len(r.generated) for r in self.finished)
        pool_tokens = self.pager.pool_tokens
        # terminal accounting straight off the retired requests themselves:
        # correct even with the metrics registry nulled (REPRO_TELEMETRY=0)
        by_state: Dict[RequestState, int] = {}
        by_reason: Dict[str, int] = {}
        for r in self._done.values():
            by_state[r.state] = by_state.get(r.state, 0) + 1
            by_reason[r.finish_reason] = by_reason.get(r.finish_reason, 0) + 1
        out = {
            "engine": "paged",
            "machine": get_machine().name,
            "device": str(self.device),
            "requests": self._next_rid,
            "live": len(self._requests),
            "completed": len(self.finished),
            "cancelled": by_state.get(RequestState.CANCELLED, 0),
            "failed": by_state.get(RequestState.FAILED, 0),
            "shed": by_reason.get("shed", 0),
            "deadline_expired": by_reason.get("deadline", 0),
            "stalled": by_reason.get("stalled", 0),
            "stalls": int(self._c_stalls.value),
            "step_faults": int(self._c_step_faults.value),
            "faults_injected": self.faults.injected,
            "substrate": guard.stats(),  # process-wide guarded-call totals
            "rounds": self.rounds,
            "decode_rounds": self.decode_rounds,
            "preemptions": self.scheduler.preemptions,
            "round_width": self.round_width,
            "solved_depth": self.solved_depth,
            "token_budget": self.token_budget,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": self.prefiller.chunks_run,
            "block_size": self.pager.block_size,
            "num_blocks": self.pager.num_blocks,
            "pool_tokens": pool_tokens,
            "blocks_allocated": self.pager.blocks_allocated,
            "aggregate_kv_tokens": agg_kv,
            "kv_oversubscription": round(agg_kv / max(pool_tokens, 1), 2),
            "prefix_cache": self.prefix_cache is not None,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens": self.prefix_tokens,
            "blocks_shared": self.blocks_shared,
            "cow_forks": self.cow_forks,
            "cache_blocks": (len(self.prefix_cache)
                             if self.prefix_cache else 0),
            "cache_evictions": (self.prefix_cache.evictions
                                if self.prefix_cache else 0),
            "prefill_s": round(self.prefill_s, 3),
            "decode_s": round(self.decode_s, 3),
            "decode_tok_per_s": round(decoded / max(self.decode_s, 1e-9), 1),
            "ttft_p50_ms": latency_report(self._h_ttft.samples)["p50_ms"],
            "ttft_p99_ms": latency_report(self._h_ttft.samples)["p99_ms"],
            "tbt_p50_ms": latency_report(self._h_tbt.samples)["p50_ms"],
            "tbt_p99_ms": latency_report(self._h_tbt.samples)["p99_ms"],
        }
        out.update(latency_report(self._h_token.samples))
        if self.finished:
            out["sample_tokens"] = self.finished[0].generated[:8]
        return out
