"""Chunked-prefill executor: prompt KV trickles through the paged pipeline.

A prompt is prefilled in fixed-size chunks driven through the *paged*
pipeline itself (`models.lm.prefill_chunk_paged`): each chunk writes its KV
rows directly into the request's pages and attends over everything already
resident — including shared prefix pages a cache hit put in the table,
which is what lets a request prefill only its suffix.

Chunk lengths are padded up to powers of two (floored at one block), as in
the reference package: the padding decides which rows go to the garbage
page and what a chunk computes, so both packages run the same chunks.

Capture discipline, the reference's compile discipline: the reference jits
one chunk step per (padded length, table width) with `start` / `n_valid`
as traced scalars and keeps them all; here each such key has its own
`core.step_graph.StepGraph`, so on the card a chunk is one CUDA graph,
captured at the key's first chunk (which runs eagerly first, a real chunk)
and replayed for every later chunk at that key, with the tokens, the block
table, `start` and `n_valid` copied into its buffers. Moving a chunk along
the prompt never recaptures, and chunks of 32 and 16 tokens of one prompt
alternate between two live graphs. On CPU tensors the step runs eagerly,
and so it does on a running mesh (the model's `ctx`): its MoE layers'
collectives go through gloo, which a CUDA graph cannot capture, so each
chunk is the step itself and `graphs` stays empty.

Each executed chunk after the first of its (padded length, table width)
key feeds `core.autotune.observe_pipeline` under the ``paged_prefill``
kernel key: wall clock over the page-tiles the chunk's queries attended.
The first call at a key (eager step plus capture on the card) is left out.
"""
from __future__ import annotations

import time
from typing import Dict, Set, Tuple

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.step_graph import StepGraph


def bucket_len(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) — the padded chunk length."""
    if n < 1:
        raise ValueError(f"bucket_len needs n >= 1, got {n}")
    return 1 << (max(int(n), int(floor), 1) - 1).bit_length()


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ChunkedPrefiller:
    """Runs paged prefill chunk steps at pow2-bucketed lengths, one
    `StepGraph` per (padded length, table width); eagerly on a mesh
    (`model.ctx`)."""

    def __init__(self, model, block_size: int, device):
        self.model = model
        self.block_size = int(block_size)
        self.device = torch.device(device)
        self.eager = model.ctx.mesh is not None
        # (padded_len, table_width) -> its step: the reference's `_fns`
        self.graphs: Dict[Tuple[int, int], StepGraph] = {}
        self._warm: Set[Tuple[int, int]] = set()  # keys already run once
        self.chunks_run = 0

    def _step(self, params, k_pools, v_pools, tokens, table, start, n_valid):
        """One chunk (pools written in place): its last real row's logits."""
        logits, _, _ = self.model.prefill_chunk_paged(
            params, k_pools, v_pools, table, start, {"tokens": tokens},
            n_valid)
        return logits

    @property
    def captures(self) -> int:
        return sum(g.captures for g in self.graphs.values())

    def _graph(self, key: Tuple[int, int]) -> StepGraph:
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(self._step, "paged_prefill")
        return graph

    def run_chunk(self, params, k_pools, v_pools, tokens, table, start: int,
                  n_valid: int):
        """Execute one prefill chunk. `tokens` is the [n_valid] real token
        slice; it is right-padded to its pow2 bucket here. `table` is the
        request's padded block table [table_width]. The pools are written in
        place and returned as given. Returns (last_logits [1, V], k_pools,
        v_pools, wall_s); on the card the logits are the key's graph output,
        rewritten by its next chunk."""
        if n_valid < 1:
            raise ValueError(f"chunk needs >= 1 tokens, got {n_valid}")
        padded = bucket_len(n_valid, floor=self.block_size)
        buf = np.zeros((1, padded), np.int64)
        buf[0, :n_valid] = np.asarray(tokens, np.int64).reshape(-1)
        table = np.asarray(table, np.int32).reshape(1, -1)
        key = (padded, table.shape[1])
        warm = key in self._warm
        inputs = (torch.from_numpy(buf), torch.from_numpy(table),
                  torch.tensor(int(start), dtype=torch.int32),
                  torch.tensor(int(n_valid), dtype=torch.int32))
        t0 = time.perf_counter()
        if self.eager:
            logits = self._step(params, k_pools, v_pools,
                                *(x.to(self.device) for x in inputs))
        else:
            logits = self._graph(key)((params, k_pools, v_pools), inputs)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self.chunks_run += 1
        self._warm.add(key)
        if warm and autotune.telemetry_enabled():
            tiles = -(-(int(start) + int(n_valid)) // self.block_size)
            autotune.observe_pipeline("paged_prefill", dt, n_tiles=max(tiles, 1))
        return logits, k_pools, v_pools, dt
