"""Chaos harness: seeded fault schedules against the paged serving engine.

Drives a randomized workload (ragged prompts, shared system-prompt
prefixes with mid-block divergence, staggered arrivals, tight pool) under
a deterministic `serve.FaultInjector` schedule — pool exhaustion, reclaim
refusal, preemption refusal, injected decode/prefill exceptions, latency
spikes, and the kernel-substrate sites (compile failure, out of memory,
NaN poisoning). The injector is installed in the guard too
(`core.guard.set_injector`), so its kernel streams also fire inside every
eager guarded kernel call, where the depth ladder walks them. It asserts
after EVERY round that

  * `KVPager.check_invariants` holds (free xor refcounted, exact
    refcounts, no garbage-page allocation), and
  * no exception escapes the engine round loop.

At drain it asserts every submitted request landed in a terminal state
(FINISHED / CANCELLED / FAILED) and that the parity sentinel (on,
``REPRO_PARITY=sampled`` unless the environment says otherwise) recorded
ZERO mismatches between the kernels and their plain versions: kernel
faults may cost throughput, never answers. Exits non-zero (an
AssertionError) on any violation; prints a JSON summary (including the
`core.guard` counters of this run: `main` can be called in a process
that has guarded other calls before) on success. On the card the engine's
decode rounds and prefill chunks are CUDA graphs: the injected kernel
faults fire in their eager pre-capture steps and in the engine's pre-step
checks.

  python -m repro_torch.launch.chaos_serve --seed 0 --rounds 50
  python -m repro_torch.launch.chaos_serve --device cpu \
      --arch granite-moe-1b-a400m
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import guard
from repro_torch.serve import (
    FaultInjector,
    PagedServingEngine,
    TERMINAL_STATES,
)

__all__ = ["build_engine", "main", "workload"]

_COUNTS = ("guarded_calls", "clean_calls", "backoffs", "parity_checks",
           "parity_mismatches", "numerics_faults", "injected_faults")


def build_engine(args) -> PagedServingEngine:
    cfg = get_config(args.arch).reduced().replace(dtype="float32",
                                                  param_dtype="float32")
    faults = FaultInjector(args.seed, latency_spike_s=args.spike_s)
    return PagedServingEngine(
        cfg, block_size=args.block_size, num_blocks=args.num_blocks,
        prefill_chunk=args.prefill_chunk, seed=args.seed, faults=faults,
        deadline_s=args.deadline_s, max_queue=args.max_queue,
        device=args.device)


def workload(args, rng, vocab):
    """(arrival_round, prompt, max_new) triples: half the prompts open with
    a shared system prefix whose tail diverges mid-block, arrivals
    staggered across the first rounds."""
    system = rng.integers(0, vocab, args.block_size + args.block_size // 2)
    jobs = []
    for i in range(args.requests):
        plen = int(rng.integers(2, args.prompt_len + 1))
        prompt = rng.integers(0, vocab, plen)
        if i % 2 == 0:
            n = min(len(system), plen - 1)  # leave >=1 token to prefill
            prompt[:n] = system[:n]
        gen = int(rng.integers(1, args.gen + 1))
        arrival = int(rng.integers(0, max(args.rounds // 2, 1)))
        jobs.append((arrival, prompt, gen))
    return sorted(jobs, key=lambda j: j[0])


def check_round(eng) -> None:
    eng.pager.check_invariants(
        eng.prefix_cache.block_refs() if eng.prefix_cache else None)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=50,
                    help="chaos rounds to drive (then drain to terminal)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--block-size", type=int, default=4)
    ap.add_argument("--num-blocks", type=int, default=10,
                    help="tight on purpose: pressure is the point")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=5)
    ap.add_argument("--prefill-chunk", type=int, default=4)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--spike-s", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    guard.set_parity(os.environ.get(guard.PARITY_ENV, "sampled"))
    eng = build_engine(args)
    before = guard.stats()
    guard.set_injector(eng.faults)
    try:
        summary = _drive(eng, args, before)
    finally:
        guard.set_injector(None)
    print(json.dumps(summary))
    return summary


def _drive(eng: PagedServingEngine, args, before: dict) -> dict:
    rng = np.random.default_rng(args.seed)
    jobs = workload(args, rng, eng.cfg.vocab)
    rids = []
    for r in range(args.rounds):
        while jobs and jobs[0][0] <= r:
            _, prompt, gen = jobs.pop(0)
            rids.append(eng.submit(prompt, max_new_tokens=gen))
        eng.step_round()
        check_round(eng)
        if not jobs and not eng.scheduler.has_work():
            break
    # late arrivals that never got their round
    for _, prompt, gen in jobs:
        rids.append(eng.submit(prompt, max_new_tokens=gen))

    stats = eng.run()  # drains; never raises on a wedged workload
    check_round(eng)

    non_terminal = [rid for rid in rids
                    if eng.request(rid).state not in TERMINAL_STATES]
    assert not non_terminal, f"requests not terminal: {non_terminal}"
    assert stats["requests"] == len(rids)
    accounted = (stats["completed"] + stats["cancelled"] + stats["failed"])
    assert accounted == len(rids), (accounted, len(rids), stats)

    # whatever the kernel sites injected, every answer the substrate
    # produced agrees with its plain version
    now = guard.stats()
    substrate = {k: v - before[k] if k in _COUNTS else v
                 for k, v in now.items()}
    assert substrate["parity_mismatches"] == 0, substrate

    return {
        "seed": args.seed,
        "device": str(eng.device),
        "rounds": stats["rounds"],
        "requests": len(rids),
        "completed": stats["completed"],
        "cancelled": stats["cancelled"],
        "failed": stats["failed"],
        "shed": stats["shed"],
        "deadline_expired": stats["deadline_expired"],
        "stalled": stats["stalled"],
        "stalls": stats["stalls"],
        "step_faults": stats["step_faults"],
        "preemptions": stats["preemptions"],
        "faults": eng.faults.stats(),
        "substrate": substrate,
    }


if __name__ == "__main__":
    main()
