"""Serving launcher: the paged continuous-batching engine.

`serve_paged` drives `repro_torch.serve.PagedServingEngine` over a batch of
ragged prompts, half of which share a system-prompt prefix, through a
block pool sized to force page reuse, and returns the engine's stats
(decode tok/s, TTFT/TBT and per-token p50/p99, prefix-cache and failure
accounting) plus every request's generated tokens.

It runs on the GPU unless asked for the CPU:

  python -m repro_torch.launch.serve --arch yi-6b --layout serving \\
      --batch 8 --prompt-len 256 --gen 32
  python -m repro_torch.launch.serve --arch yi-6b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.obs import trace as obs_trace

# ArchConfig override of the serving layout: weights stored in bf16
# (compute stays cfg.dtype, bf16 for every shipped arch).
SERVING_OVERRIDES: Dict[str, Any] = {"param_dtype": "bfloat16"}


def serve_paged(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
                block_size: int = 16, num_blocks: Optional[int] = None,
                prefix_cache: bool = True, prefill_chunk: int = 32,
                deadline_s: Optional[float] = None,
                chaos: Optional[int] = None, device=None,
                params=None, max_in_flight: Optional[int] = None):
    """Continuous batching: `batch` requests with ragged prompt lengths
    (4x spread) through a block pool sized to force page reuse. Half the
    requests share a system-prompt prefix so the prefix cache (when on) has
    something to dedup. `deadline_s` bounds each request's wall clock;
    `chaos` seeds a deterministic fault schedule (serve.FaultInjector).
    `device` None means the GPU; `params` None draws random weights from
    `seed` on that device. The prompts are the reference package's for the
    same seed."""
    from repro_torch.serve import FaultInjector, PagedServingEngine

    faults = FaultInjector(chaos) if chaos is not None else None
    rng = np.random.default_rng(seed)
    lo = max(1, prompt_len // 4)
    plens = [int(x) for x in rng.integers(lo, prompt_len + 1, batch)]
    plens[int(np.argmax(plens))] = prompt_len  # keep the nominal worst case

    blocks_per_req = -(-(prompt_len + gen) // block_size)
    if num_blocks is None:
        # roughly half the requests resident at once: completions must free
        # pages for later admissions (the continuous-batching regime)
        num_blocks = blocks_per_req * max(2, (batch + 1) // 2)

    system = rng.integers(0, cfg.vocab, max(lo // 2, 1))
    eng = PagedServingEngine(cfg, block_size=block_size,
                             num_blocks=num_blocks, seed=seed,
                             prefix_cache=prefix_cache,
                             prefill_chunk=prefill_chunk,
                             deadline_s=deadline_s, faults=faults,
                             device=device, params=params,
                             max_in_flight=max_in_flight)
    rids = []
    for i, plen in enumerate(plens):
        body = rng.integers(0, cfg.vocab, plen)
        if i % 2 == 0:  # every other request opens with the system prompt
            body[: len(system)] = system[: plen]
        rids.append(eng.submit(body, max_new_tokens=gen))
    stats = eng.run()
    stats["prompt_lens"] = plens
    stats["generated"] = [list(eng.request(r).generated) for r in rids]
    stats["states"] = [eng.request(r).state.value for r in rids]
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layout", default="default", choices=["default", "serving"],
                    help="serving: bf16 weight storage")
    ap.add_argument("--engine", default="paged", choices=["paged"],
                    help="the paged engine is the one this package serves")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="share KV pages across common prompt prefixes "
                         "(--no-prefix-cache disables)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="tokens per chunked-prefill step")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline in seconds; "
                         "expired requests are CANCELLED at the next round "
                         "boundary")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject a deterministic fault schedule seeded by SEED")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export the run's span trace as Chrome trace-event "
                         "JSON (open in https://ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layout == "serving":
        cfg = cfg.replace(**SERVING_OVERRIDES)
    stats = serve_paged(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, seed=args.seed,
                        block_size=args.block_size, num_blocks=args.num_blocks,
                        prefix_cache=args.prefix_cache,
                        prefill_chunk=args.prefill_chunk,
                        deadline_s=args.deadline_s, chaos=args.chaos,
                        device=args.device)
    if args.trace:
        stats["trace"] = obs_trace.get_tracer().export(args.trace)
        stats["trace_events"] = len(obs_trace.get_tracer().events)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
