"""Deterministic, resumable, host-sharded data pipeline: the reference
package's ``data/pipeline.py``, kept as the port's own copy (numpy only).

`batch_for_step(step)` is a pure function of (seed, step, shard): a restart
at any step reproduces the exact token stream with no iterator state to
persist (the checkpoint stores only the step counter). That property makes
checkpoint/restart exact (`runtime.train_loop.train` resumes from the
checkpoint's step). For the same (seed, step, shard) the batches are
bitwise those of the reference.

The synthetic task is a fixed seeded Markov chain over the vocabulary, so
models have a real learnable signal with a known loss floor (the chain's
conditional entropy): `launch.quickstart` and `launch.train_100m` show the
loss dropping toward it. Batches are numpy arrays; the train loop moves
them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branching: int = 4          # successors per token (lower = easier task)
    num_shards: int = 1         # data-parallel host count
    shard: int = 0


class MarkovTask:
    """Seeded bigram language with `branching` successors per token."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab, cfg.branching
        self.succ = rng.integers(0, v, size=(v, b), dtype=np.int32)
        probs = rng.dirichlet(np.ones(b) * 2.0, size=v).astype(np.float64)
        self.probs = probs / probs.sum(-1, keepdims=True)

    def entropy(self) -> float:
        """Conditional entropy in nats — the achievable loss floor."""
        p = self.probs
        return float(-(p * np.log(p)).sum(-1).mean())

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % cfg.num_shards == 0
        local = cfg.global_batch // cfg.num_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.shard
        )
        toks = np.empty((local, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=local)
        for t in range(cfg.seq_len):
            cur = toks[:, t]
            u = rng.random(local)
            cum = self.probs[cur].cumsum(-1)
            choice = (u[:, None] < cum).argmax(-1)
            toks[:, t + 1] = self.succ[cur, choice]
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "positions": np.tile(np.arange(cfg.seq_len, dtype=np.int32), (local, 1)),
        }


class PrefetchIterator:
    """Background-thread prefetch of upcoming steps (overlap host datagen
    with device compute — the host-side analogue of the coroutine pipeline)."""

    def __init__(self, task: MarkovTask, start_step: int = 0, depth: int = 2):
        self.task = task
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.task.batch_for_step(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
