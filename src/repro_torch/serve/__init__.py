"""Paged-KV continuous-batching serving on the coroutine substrate.

  kv_pager     - device block pool bookkeeping: refcounted tables, COW forks
  prefix_cache - radix index: shared prompt prefixes -> shared KV pages
  prefill      - chunked prefill through the paged pipeline (pow2 chunks)
  scheduler    - admit/evict/preempt; budgeted rounds mixing decode + chunks
  faults       - seeded deterministic fault injection (chaos schedules)
  engine       - the serving loop wiring them together, streaming completions
"""
from repro_torch.serve.engine import PagedServingEngine, latency_report, resolve_device
from repro_torch.serve.faults import NULL_INJECTOR, FaultInjector, InjectedFault
from repro_torch.serve.kv_pager import GARBAGE_BLOCK, KVPager, PoolExhausted
from repro_torch.serve.prefill import ChunkedPrefiller, bucket_len
from repro_torch.serve.prefix_cache import MISS, PrefixCache, PrefixMatch
from repro_torch.serve.scheduler import (
    TERMINAL_STATES,
    ContinuousBatchingScheduler,
    Request,
    RequestState,
)

__all__ = [
    "ChunkedPrefiller",
    "ContinuousBatchingScheduler",
    "FaultInjector",
    "GARBAGE_BLOCK",
    "InjectedFault",
    "KVPager",
    "MISS",
    "NULL_INJECTOR",
    "PagedServingEngine",
    "PoolExhausted",
    "PrefixCache",
    "PrefixMatch",
    "Request",
    "RequestState",
    "TERMINAL_STATES",
    "bucket_len",
    "latency_report",
    "resolve_device",
]
