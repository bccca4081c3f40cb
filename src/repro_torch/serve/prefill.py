"""Chunked-prefill executor: prompt KV trickles through the paged pipeline.

A prompt is prefilled in fixed-size chunks driven through the *paged*
pipeline itself (`models.lm.prefill_chunk_paged`): each chunk writes its KV
rows directly into the request's pages and attends over everything already
resident — including shared prefix pages a cache hit put in the table,
which is what lets a request prefill only its suffix.

Chunk lengths are padded up to powers of two (floored at one block), as in
the reference package: the padding decides which rows go to the garbage
page and what a chunk computes, so both packages run the same chunks.

Each executed chunk after the first of its (padded length, table width)
shape feeds `core.autotune.observe_pipeline` under the ``paged_prefill``
kernel key: wall clock over the page-tiles the chunk's queries attended.
"""
from __future__ import annotations

import time
from typing import Set, Tuple

import numpy as np
import torch

from repro_torch.core import autotune


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
    """Runs paged prefill chunk steps at pow2-bucketed lengths."""

    def __init__(self, model, block_size: int, device):
        self.model = model
        self.block_size = int(block_size)
        self.device = torch.device(device)
        self._warm: Set[Tuple[int, int]] = set()  # shapes already run once
        self.chunks_run = 0

    def run_chunk(self, params, k_pools, v_pools, tokens, table, start: int,
                  n_valid: int):
        """Execute one prefill chunk. `tokens` is the [n_valid] real token
        slice; it is right-padded to its pow2 bucket here. `table` is the
        request's padded block table [table_width]. The pools are written in
        place. Returns (last_logits [1, V], k_pools, v_pools, wall_s)."""
        if n_valid < 1:
            raise ValueError(f"chunk needs >= 1 tokens, got {n_valid}")
        padded = bucket_len(n_valid, floor=self.block_size)
        buf = np.zeros((1, padded), np.int64)
        buf[0, :n_valid] = np.asarray(tokens, np.int64).reshape(-1)
        table = np.asarray(table, np.int32).reshape(1, -1)
        key = (padded, table.shape[1])
        warm = key in self._warm
        t0 = time.perf_counter()
        logits, k_pools, v_pools = self.model.prefill_chunk_paged(
            params, k_pools, v_pools,
            torch.from_numpy(table).to(self.device), int(start),
            {"tokens": torch.from_numpy(buf).to(self.device)}, int(n_valid))
        synchronize(self.device)
        dt = time.perf_counter() - t0
        self.chunks_run += 1
        self._warm.add(key)
        if warm and autotune.telemetry_enabled():
            tiles = -(-(int(start) + int(n_valid)) // self.block_size)
            autotune.observe_pipeline("paged_prefill", dt, n_tiles=max(tiles, 1))
        return logits, k_pools, v_pools, dt
