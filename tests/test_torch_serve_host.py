"""The port's host bookkeeping against the JAX reference's.

`KVPager`, `PrefixCache`, `ContinuousBatchingScheduler` and `FaultInjector`
of both packages are driven by one op sequence and one fault seed; after
every step the block tables, refcounts, free lists, evict order, request
states and injector draws must be equal.
"""
import types

import numpy as np
import pytest

import repro_torch
from repro.serve import faults as ref_faults
from repro.serve import kv_pager as ref_pager
from repro.serve import prefix_cache as ref_cache
from repro.serve import scheduler as ref_sched
from repro_torch.serve import faults, kv_pager, prefix_cache, scheduler


def _ns(f, p, c, s):
    return types.SimpleNamespace(
        FaultInjector=f.FaultInjector, KVPager=p.KVPager,
        PoolExhausted=p.PoolExhausted, GARBAGE_BLOCK=p.GARBAGE_BLOCK,
        PrefixCache=c.PrefixCache, Scheduler=s.ContinuousBatchingScheduler,
        Request=s.Request, RequestState=s.RequestState)


REF = _ns(ref_faults, ref_pager, ref_cache, ref_sched)
PORT = _ns(faults, kv_pager, prefix_cache, scheduler)


@pytest.fixture(autouse=True)
def _reset_port():
    repro_torch.reset()
    yield
    repro_torch.reset()


def _pager_state(pager):
    return (tuple(pager._free), tuple(sorted(pager._refcounts.items())),
            tuple(sorted((r, tuple(t)) for r, t in pager._tables.items())),
            tuple(sorted(pager._lengths.items())), pager.blocks_allocated)


def _injector_state(inj):
    return (inj.injected, dict(inj.by_site), list(inj.log))


# ------------------------------------------------------------------- pager


def _pager_trace(ns, seed):
    rng = np.random.RandomState(1000 + seed)
    inj = ns.FaultInjector(seed, rates={"pool_exhausted": 0.08})
    pager = ns.KVPager(num_blocks=16, block_size=4, faults=inj)
    live, next_rid, cache_refs = [], 0, {}
    trace = []
    for step in range(400):
        op = str(rng.choice(["alloc", "append", "share", "evict", "free",
                             "fork", "pop"]))
        res = None
        try:
            if op == "alloc":
                n = int(rng.randint(1, 20))
                res = pager.alloc(next_rid, n)
                live.append(next_rid)
                next_rid += 1
            elif op == "append" and live:
                rid = live[rng.randint(len(live))]
                res = pager.append_token(rid)
                res = (res, pager.ensure_writable(rid, res))
            elif op == "share" and live:
                rid = live[rng.randint(len(live))]
                table = pager.block_table(rid)
                b = table[rng.randint(len(table))]
                pager.share(b)
                cache_refs[b] = cache_refs.get(b, 0) + 1
            elif op == "evict" and cache_refs:
                b = sorted(cache_refs)[rng.randint(len(cache_refs))]
                res = pager.release(b)
                cache_refs[b] -= 1
                if cache_refs[b] == 0:
                    del cache_refs[b]
            elif op == "free" and live:
                rid = live.pop(rng.randint(len(live)))
                res = pager.free(rid)
            elif op == "fork" and live:
                rid = live[rng.randint(len(live))]
                res = pager.ensure_writable(rid, rng.randint(pager.length(rid)))
            elif op == "pop" and live:
                rid = live[rng.randint(len(live))]
                if pager.length(rid) > 1:
                    pager.append_token(rid)
                    pager.pop_token(rid)
        except ns.PoolExhausted as e:
            res = f"PoolExhausted: {e}"
        pager.check_invariants(extra_refs=cache_refs)
        trace.append((step, op, res, _pager_state(pager)))
    return trace, _injector_state(inj)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pager_fuzz_replays_identically(seed):
    ref_trace, ref_inj = _pager_trace(REF, seed)
    trace, inj = _pager_trace(PORT, seed)
    assert trace == ref_trace
    assert inj == ref_inj
    assert inj[0] > 0          # the fault stream did fire
    assert kv_pager.GARBAGE_BLOCK == ref_pager.GARBAGE_BLOCK == 0


# ------------------------------------------------------------ prefix cache


def _cache_trace(ns, seed):
    rng = np.random.RandomState(2000 + seed)
    pager = ns.KVPager(num_blocks=24, block_size=4)
    cache = ns.PrefixCache(pager)
    heads = [rng.randint(0, 9, n).tolist() for n in (6, 9, 13)]
    live, next_rid = [], 0
    trace = []
    for step in range(300):
        op = str(rng.choice(["admit", "admit", "free", "evict", "match"]))
        res = None
        if op in ("admit", "match"):
            head = heads[rng.randint(len(heads))]
            prompt = head[: rng.randint(len(head) + 1)] + \
                rng.randint(0, 9, rng.randint(1, 8)).tolist()
            m = cache.match(prompt)
            res = (tuple(m.blocks), m.n_tokens)
            if op == "admit":
                try:
                    pager.alloc(next_rid, len(prompt), prefix_blocks=m.blocks,
                                prefix_len=m.n_tokens)
                except ns.PoolExhausted:
                    res = res + ("exhausted",)
                else:
                    if m.n_tokens % pager.block_size:
                        try:      # the suffix write forks the partial page
                            res = res + (pager.ensure_writable(
                                next_rid, m.n_tokens),)
                        except ns.PoolExhausted:
                            res = res + ("fork-exhausted",)
                    res = res + (cache.insert(prompt,
                                              pager.block_table(next_rid)),)
                    live.append(next_rid)
                    next_rid += 1
        elif op == "free" and live:
            res = pager.free(live.pop(rng.randint(len(live))))
        elif op == "evict":
            protect = frozenset(int(b) for b in
                                rng.randint(1, 25, rng.randint(0, 4)))
            res = tuple(cache.evict(int(rng.randint(1, 5)), protect))
        pager.check_invariants(cache.block_refs())
        trace.append((step, op, res, _pager_state(pager),
                      tuple(sorted(cache.block_refs())), cache.evictions,
                      len(cache)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_match_insert_evict_order_identical(seed):
    ref_trace = _cache_trace(REF, seed)
    trace = _cache_trace(PORT, seed)
    assert trace == ref_trace
    assert any(step[1] == "evict" and step[2] for step in trace)


# --------------------------------------------------------------- scheduler


def _sched_trace(ns, seed):
    """An engine-shaped round loop without a model: admit with prefix
    matches, budgeted plans, decode reservations with COW, prefill chunks,
    preemption and reclaim under a seeded fault schedule."""
    rng = np.random.RandomState(3000 + seed)
    inj = ns.FaultInjector(seed, rates={"pool_exhausted": 0.05,
                                        "preempt_refuse": 0.2,
                                        "reclaim_refuse": 0.1})
    pager = ns.KVPager(num_blocks=12, block_size=4, faults=inj)
    cache = ns.PrefixCache(pager)

    def reclaim(n, protect):
        if inj.fire("reclaim_refuse", requested=n):
            return 0
        return len(cache.evict(n, protect))

    sched = ns.Scheduler(pager, 3, token_budget=8, reclaim=reclaim,
                         faults=inj)
    system = rng.randint(0, 20, 6).tolist()
    reqs = []
    for rid in range(8):
        body = rng.randint(0, 20, rng.randint(2, 14)).tolist()
        prompt = (system + body) if rid % 2 == 0 else body
        req = ns.Request(rid=rid, prompt=prompt,
                         max_new_tokens=int(rng.randint(1, 7)))
        sched.submit(req)
        reqs.append(req)
    running, prefill = ns.RequestState.RUNNING, ns.RequestState.PREFILL
    trace = []
    for rnd in range(80):
        if not sched.has_work():
            break
        admitted = [r.rid for r in sched.admit(match=cache.match)]
        decodes, plans = sched.plan_round(4)
        for req in decodes:
            if req.state is not running:
                continue
            try:
                pos = sched.reserve_decode_slot(req)
                if req.state is running:
                    sched.make_writable(req, pos)
            except ns.PoolExhausted:
                sched.requeue(req)
                continue
            if req.state is running:
                req.generated.append(int(rng.randint(0, 20)))
                if req.done:
                    sched.finish(req)
        for req, n in plans:
            if req.state is not prefill:
                continue
            try:
                sched.make_writable(req, req.prefill_pos)
            except ns.PoolExhausted:
                sched.requeue(req)
                continue
            if req.state is not prefill:
                continue
            req.prefill_pos += min(n, len(req.context) - req.prefill_pos)
            cache.insert(req.context[:req.prefill_pos],
                         pager.block_table(req.rid))
            if req.prefill_pos >= len(req.context):
                req.generated.append(int(rng.randint(0, 20)))
                if req.done:
                    sched.finish(req)
                else:
                    sched.promote(req)
        pager.check_invariants(cache.block_refs())
        trace.append((rnd, admitted,
                      [(r.rid, r.state.value, r.prefill_pos, r.kv_len,
                        tuple(r.generated), r.preemptions, r.admit_seq)
                       for r in reqs],
                      sched.preemptions, [r.rid for r in sched.waiting],
                      _pager_state(pager), cache.evictions))
    return trace, _injector_state(inj)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_rounds_replay_identically(seed):
    ref_trace, ref_inj = _sched_trace(REF, seed)
    trace, inj = _sched_trace(PORT, seed)
    assert trace == ref_trace
    assert inj == ref_inj
    final = trace[-1][2]
    assert all(state == "finished" for _, state, *_ in final)


def test_injector_draws_identical_per_site():
    """Every site draws from its own (seed, site_index) stream in both
    packages: the same calls give the same decisions, spikes and logs."""
    ref_inj = REF.FaultInjector(11)
    inj = PORT.FaultInjector(11)
    assert faults.SITES == ref_faults.SITES
    assert faults.DEFAULT_RATES == ref_faults.DEFAULT_RATES
    rng = np.random.RandomState(5)
    for i in range(500):
        site = faults.SITES[rng.randint(len(faults.SITES))]
        if site == "latency":
            assert inj.latency_spike() == ref_inj.latency_spike()
        else:
            assert inj.fire(site, i=i) == ref_inj.fire(site, i=i)
    assert _injector_state(inj) == _injector_state(ref_inj)
    assert inj.injected > 0
