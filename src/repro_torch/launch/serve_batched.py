"""Batched serving over the three cache families, then the paged engine.

The dense demo serves reduced yi-6b (a full KV cache through the
flash-decode kernel), hymba-1.5b (a sliding-window ring beside SSM heads)
and mamba2-130m (recurrent state; its prefill through the SSD-scan
kernel) through `launch.serve.serve`. For each attention arch it also
prints what the flash-decode kernel's declaration gives at that arch's
heads: the context bytes of its `CoroSpec` (K/V slots x depth plus the
shared online-softmax state) and the depth `core.autotune` solves from
it, the same numbers as the reference package's
(`examples/serve_batched.py`) under one `REPRO_MACHINE`.

The paged demo drives `serve.PagedServingEngine` with ragged prompts
through a block pool that holds about two of them, so completions must
free pages for later admissions: every request must finish, and the
aggregate KV must exceed the pool at least twice over. The prefix demo
serves eight requests that open with one system prompt with the prefix
cache on and off: the warm run must share pages, allocate fewer blocks and
emit the same tokens.

    python -m repro_torch.launch.serve_batched [--engine dense|paged|both]
    python -m repro_torch.launch.serve_batched --device cpu

It runs on the GPU unless asked for the CPU.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import autotune
from repro_torch.kernels.decode_attention.decode_attention import decode_spec
from repro_torch.launch.serve import serve

DENSE_ARCHS = ("yi-6b", "hymba-1.5b", "mamba2-130m")


def flash_decode_context(cfg) -> Dict[str, int]:
    """The flash-decode kernel's declaration at `cfg`'s heads (128-row bf16
    tiles): its solved depth and context bytes, and the all-private
    baseline's bytes at that depth."""
    d = cfg.resolved_head_dim
    g = max(cfg.n_heads // cfg.kv_heads, 1)
    spec = decode_spec(128, cfg.kv_heads, g, d, torch.bfloat16)
    depth = autotune.choose_depth(spec.profile(), vars=spec.all_vars())
    return {"depth": depth, "context_bytes": spec.context_bytes(depth),
            "baseline_bytes": spec.context_bytes(depth, baseline=True)}


def dense_demo(device=None) -> Dict[str, dict]:
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch).reduced()
        stats = serve(cfg, batch=4, prompt_len=48, gen=12, device=device)
        shown = {k: v for k, v in stats.items() if k != "generated"}
        print(f"{arch:15s} {shown}")
        out[arch] = {"stats": stats}
        if cfg.n_heads and cfg.kv_heads:
            ctx = flash_decode_context(cfg)
            print(f"{'':15s} flash-decode spec: depth {ctx['depth']}, "
                  f"context {ctx['context_bytes']} B (all-private baseline "
                  f"{ctx['baseline_bytes']} B)")
            out[arch].update(ctx)
    return out


def paged_demo(device=None) -> dict:
    """Serve 8 ragged requests through a pool that holds ~2 of them: the
    aggregate KV footprint exceeds the pool (and any dense [batch, max_len]
    carve-up of the same memory) by >2x, yet every request completes."""
    from repro_torch.serve import PagedServingEngine

    cfg = get_config("yi-6b").reduced()
    rng = np.random.default_rng(0)
    block_size, gen = 8, 10
    plens = [10, 40, 12, 36, 9, 28, 14, 33]
    blocks_per_req = -(-(max(plens) + gen) // block_size)
    eng = PagedServingEngine(cfg, block_size=block_size,
                             num_blocks=2 * blocks_per_req, max_in_flight=3,
                             device=device)
    for plen in plens:
        eng.submit(rng.integers(0, cfg.vocab, plen), max_new_tokens=gen)
    stats = eng.run()
    keys = ("requests", "completed", "rounds", "preemptions", "round_width",
            "solved_depth", "pool_tokens", "aggregate_kv_tokens",
            "kv_oversubscription", "decode_tok_per_s", "p50_ms", "p99_ms")
    print(f"{'paged yi-6b':15s} " + " ".join(f"{k}={stats[k]}" for k in keys))
    assert stats["completed"] == len(plens), stats
    assert stats["kv_oversubscription"] >= 2.0, stats
    return stats


def prefix_demo(device=None) -> dict:
    """8 requests opening with one shared system prompt, cache on vs off:
    the warm run reuses the prefix pages (prefix_hits > 0) and pops strictly
    fewer physical blocks off the pool, emitting identical tokens."""
    from repro_torch.models import build_model
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.engine import resolve_device

    cfg = get_config("yi-6b").reduced()
    dev = resolve_device(device)
    gen_ = torch.Generator(device=dev)
    gen_.manual_seed(0)
    params = build_model(cfg).init(gen_, dev)
    rng = np.random.default_rng(0)
    block_size, gen = 8, 6
    system = list(rng.integers(0, cfg.vocab, 3 * block_size))
    prompts = [system + list(rng.integers(0, cfg.vocab, 5 + i % 6))
               for i in range(8)]

    def run(prefix_cache):
        eng = PagedServingEngine(cfg, block_size=block_size, num_blocks=64,
                                 params=params, max_in_flight=2,
                                 prefix_cache=prefix_cache, device=dev)
        rids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
        stats = eng.run()
        return [list(eng.request(r).generated) for r in rids], stats

    warm_toks, warm = run(True)
    cold_toks, cold = run(False)
    keys = ("prefix_hits", "prefix_tokens", "blocks_shared",
            "blocks_allocated", "cow_forks", "cache_blocks", "ttft_p50_ms")
    print(f"{'prefix yi-6b':15s} warm: "
          + " ".join(f"{k}={warm[k]}" for k in keys))
    print(f"{'':15s} cold: blocks_allocated={cold['blocks_allocated']} "
          f"prefix_hits={cold['prefix_hits']}")
    assert warm_toks == cold_toks, "prefix cache changed emitted tokens"
    assert warm["prefix_hits"] > 0, warm
    assert warm["blocks_allocated"] < cold["blocks_allocated"], (warm, cold)
    return warm


def main(argv: List[str] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="both",
                    choices=["dense", "paged", "both"])
    ap.add_argument("--prefix-cache", action="store_true",
                    help="run the shared-prefix dedup demo (paged engine)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = {}
    if args.engine in ("dense", "both"):
        out["dense"] = dense_demo(args.device)
    if args.engine in ("paged", "both"):
        out["paged"] = paged_demo(args.device)
        if args.prefix_cache or args.engine == "paged":
            out["prefix"] = prefix_demo(args.device)
    return out


if __name__ == "__main__":
    main()
