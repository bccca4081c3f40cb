"""Serving launcher: batched prefill + decode with KV caches.

Two engines, as in the reference package:

  dense - the fixed-batch baseline (the default): one ``[batch, max_len]``
          cache per layer, `model.prefill` once, then `model.decode_step`
          for every token through `jit_decode_step` (on the GPU one CUDA
          graph a step), timed one step at a time (`serve`,
          `timed_decode_loop`). It serves every family: dense, MoE,
          Mamba-2 SSM, hybrid (a sliding-window ring beside SSM heads),
          encoder-decoder (frame embeddings through an encoder, then
          cross-attention) and VLM (patch embeddings as a prefix); its
          decode attention, over a cache, a ring or the encoder's output,
          is the `flash_decode` kernel and its SSM prefill the `ssd_scan`
          kernel.
  paged - `repro_torch.serve.PagedServingEngine` (`serve_paged`):
          continuous batching over a paged KV block pool, ragged prompt
          lengths, half of them sharing a system-prompt prefix, through a
          pool sized to force page reuse (on the GPU one CUDA graph a
          decode round).

Prefill runs eagerly in both.

Both engines also serve on a device mesh (`serve(..., ctx=...)` on every
rank of `launch.mesh.spawn`, or `serve_on_mesh`). The dense engine: each
rank takes its `data` slice of the batch, holds its `model` share of the
experts and of the sequence-split KV caches, and runs the same prefill
and decode steps with the MoE expert-parallel and the decode attention
merged over `model`. The paged engine: each rank runs the whole engine
in lockstep with the others, holds its share of the experts and the
whole KV pools, and its MoE layers are expert-parallel (`serve/engine.py`).
Their steps run eagerly there: collectives over gloo cannot be captured
in a CUDA graph. `serve_placed` runs the reference's placed serving step
on a rank instead (`runtime.steps.jit_prefill_step`, `jit_decode_step`:
weights and caches placed by their rules, tensor-parallel over `model`).

Both report decode tok/s and per-token p50/p99 (the paged engine also
TTFT/TBT, prefix-cache and failure accounting) plus every request's
generated tokens. They run on the GPU unless asked for the CPU:

  python -m repro_torch.launch.serve --arch yi-6b --layout serving \\
      --batch 8 --prompt-len 1024 --gen 32
  python -m repro_torch.launch.serve --arch mamba2-130m --batch 8 \\
      --prompt-len 2048 --gen 32
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
      --layout serving --engine paged --batch 8 --prompt-len 256 --gen 32
  python -m repro_torch.launch.serve --arch hymba-1.5b --layout serving \\
      --batch 8 --prompt-len 2048 --gen 32
  python -m repro_torch.launch.serve --arch whisper-medium --reduced \\
      --device cpu
  python -m repro_torch.launch.serve --arch mamba2-130m --reduced --device cpu
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --reduced \\
      --engine paged --device cpu
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --reduced \\
      --device cpu --mesh 1x2
  python -m repro_torch.launch.serve --arch yi-6b --layout serving \\
      --batch 8 --prompt-len 1024 --gen 32 --mesh 1x2 --backend gloo
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --reduced \\
      --engine paged --mesh 1x2 --device cpu --backend gloo
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, token_split
from repro_torch.core import autotune, guard
from repro_torch.core.machine import get_machine
from repro_torch.core.step_graph import StepGraph
from repro_torch.models.params import torch_dtype
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import latency_report
from repro_torch.runtime.layouts import serving_config_overrides
from repro_torch.runtime.steps import jit_decode_step
from repro_torch.sharding import NULL_CTX, ShardingCtx, local_shard

# ArchConfig overrides of the serving layout: weights stored in bf16
# (compute stays cfg.dtype, bf16 for every shipped arch) and the
# row-granular KV write of the sequence-split decode.
SERVING_OVERRIDES: Dict[str, Any] = serving_config_overrides()

def make_prompts(cfg, batch: int, prompt_len: int, rng, device):
    """Random prompts from the numpy generator `rng` (the reference's draws
    for the same seed, in its order). Returns ({"tokens": [batch, text]
    int32, and for a stub frontend "frames" (enc-dec) or "patches" (VLM):
    [batch, front, d_model] of normal * 0.02, rounded to bf16, in
    cfg.dtype}, text)."""
    front, text = token_split(cfg, prompt_len)
    tokens = rng.integers(0, cfg.vocab, (batch, text))
    b = {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device=device)}
    for key, on in (("frames", cfg.enc_dec), ("patches", cfg.vlm)):
        if on:
            emb = rng.normal(size=(batch, front, cfg.d_model)) * 0.02
            b[key] = torch.as_tensor(emb).to(torch.bfloat16).to(
                device=device, dtype=torch_dtype(cfg.dtype))
    return b, text


def timed_decode_loop(decode, params, cache, tokens, *, steps, make_batch):
    """Drive `steps` decode calls, timing each to its tokens on the host.

    Returns (tokens_list, final_tokens, per-step latencies in seconds). The
    per-step synchronisation is what makes p50/p99 meaningful; its cost is
    inside the latencies. A step whose logits are not finite is counted in
    `guard.stats()` and, in strict mode, raises `KernelNumericsError`
    (the dense loop has no step to retry). Each step's logits
    are read (argmax, then the scan) before the next call, which may
    overwrite them (`runtime.steps.jit_decode_step`)."""
    out = [tokens]
    lat = []
    tracer = obs_trace.get_tracer()  # fetched once: null no-op when off
    for i in range(steps):
        t0 = time.perf_counter()
        with tracer.span("decode_step", step=i, batch=int(tokens.shape[0])):
            logits, cache = decode(params, cache, make_batch(tokens, i))
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            if tokens.is_cuda:
                torch.cuda.synchronize(tokens.device)
        dt = time.perf_counter() - t0
        lat.append(dt)
        nerr = guard.scan_output("serve_dense_decode", logits)
        if nerr is not None and guard.strict_mode():
            raise nerr
        if autotune.telemetry_enabled():
            # one "tile" per request token this step; the first observation
            # is dropped by observe_pipeline's warm-up skip
            autotune.observe_pipeline("serve_dense_decode", dt,
                                      int(tokens.shape[0]))
        out.append(tokens)
    return out, tokens, lat


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          engine: str = "dense", block_size: int = 16,
          num_blocks: Optional[int] = None, prefix_cache: bool = True,
          prefill_chunk: int = 32, deadline_s: Optional[float] = None,
          chaos: Optional[int] = None, device=None, params=None,
          max_in_flight: Optional[int] = None, strict: bool = False,
          ctx: ShardingCtx = NULL_CTX, layout: str = "default"):
    """Serve `batch` prompts of `prompt_len` tokens, `gen` new tokens each.

    engine="dense" (the default): one prefill of the whole batch into
    caches padded to ``prompt_len + gen`` rows, then ``gen - 1`` decode
    steps. engine="paged": `serve_paged`. `device` None means the GPU
    (RuntimeError where there is none); `params` None draws random weights
    from `seed` on that device. The prompts are the reference package's
    for the same seed. `strict` turns on the guard's strict mode
    (`core.guard.set_strict`) for the rest of the process. `layout`
    "serving" applies `SERVING_OVERRIDES` to `cfg`.

    With a `ctx` whose mesh runs (each rank of `launch.mesh.spawn` calls
    this), either engine serves on the mesh (the dense one through
    `_serve_mesh`, the paged one through `serve_paged`): `device` must
    name the ranks' device type (None: the GPU), and `params`, when
    given, are this rank's."""
    from repro_torch.models import build_model
    from repro_torch.serve.engine import resolve_device

    if strict:
        # no degradation: a substrate fault raises its typed error
        guard.set_strict(True)
    if layout == "serving":
        cfg = cfg.replace(**SERVING_OVERRIDES)
    elif layout != "default":
        raise ValueError(f"unknown layout {layout!r} (default or serving)")
    if engine == "paged":
        return serve_paged(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                           seed=seed, block_size=block_size,
                           num_blocks=num_blocks, prefix_cache=prefix_cache,
                           prefill_chunk=prefill_chunk, deadline_s=deadline_s,
                           chaos=chaos, device=device, params=params,
                           max_in_flight=max_in_flight, ctx=ctx)
    if engine != "dense":
        raise ValueError(f"unknown engine {engine!r} (dense or paged)")
    if deadline_s is not None or chaos is not None:
        raise ValueError("--deadline-s / --chaos need --engine paged (the "
                         "dense baseline has no per-request lifecycle)")
    if ctx.mesh is not None:
        return _serve_mesh(cfg, ctx, batch=batch, prompt_len=prompt_len,
                           gen=gen, seed=seed, device=device, params=params)
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        params = model.init(g, dev)
    rng = np.random.default_rng(seed)
    prompts, text_len = make_prompts(cfg, batch, prompt_len, rng, dev)

    t0 = time.perf_counter()
    cache, logits = model.prefill(params, prompts, pad_to=text_len + gen)
    tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter() - t0

    def make_batch(tokens, i):
        return {"tokens": tokens}

    decode = jit_decode_step(model)
    out, tokens, lat = timed_decode_loop(decode, params, cache, tokens,
                                         steps=gen - 1, make_batch=make_batch)
    t_decode = sum(lat)
    generated = torch.cat(out, dim=1).cpu()
    stats = {
        "engine": "dense",
        "machine": get_machine().name,
        "device": str(dev),
        "generated_shape": tuple(generated.shape),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "decode_captures": decode.graph.captures,
        "sample_tokens": generated[0, :8].tolist(),
        "substrate": guard.stats(),
        "generated": generated.tolist(),
    }
    stats.update(latency_report(lat))
    return stats


def _serve_mesh(cfg, ctx: ShardingCtx, *, batch: int, prompt_len: int,
                gen: int, seed: int, device, params, placed: bool = False):
    """The dense engine on one rank of a running mesh: this rank's `data`
    slice of the reference's prompts for `seed`, the prefill and
    ``gen - 1`` eager decode steps under `ctx` (`timed_decode_loop`), then
    every rank's tokens gathered over the batch axes. The parameters are
    held as serving holds them, or with `placed` by their rules, the
    caches then by `Model.cache_shardings` (`serve_placed`); `params`,
    when given, are this rank's in that layout. Returns the stats of
    `serve` (the whole batch's tokens under "generated", the same on
    every rank) with ``"decode_captures": 0``, the layout, the mesh, the
    bytes this rank holds (its parameters, its experts, its KV caches),
    its peak memory, and the collectives' calls, bytes and seconds in the
    decode steps (timed sync to sync: `sharding.collective_stats`)."""
    from repro_torch import sharding
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.models import build_model
    from repro_torch.runtime.steps import jit_prefill_step
    from repro_torch.serve.engine import mesh_stats, resolve_device, \
        tensor_bytes

    dev = resolve_device(device)
    if dev.type != ctx.device.type:
        raise ValueError(f"the mesh's ranks run on {ctx.device.type}, "
                         f"asked for {dev}")
    dev = ctx.device
    batch_axes = ctx.resolved_rules()["batch"]
    batch_axes = (batch_axes,) if isinstance(batch_axes, str) \
        else tuple(batch_axes or ())
    n_batch = ctx.axis_size(batch_axes or None)
    if batch % n_batch:
        raise ValueError(f"batch {batch} does not split over the mesh's "
                         f"{n_batch} data ranks")
    model = build_model(cfg, ctx)
    if params is None:
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        params = model.init(g, dev, placed=placed)
    rng = np.random.default_rng(seed)
    prompts, text_len = make_prompts(cfg, batch, prompt_len, rng, dev)
    spec = ctx.spec(("batch",), (batch,))
    prompts = {k: local_shard(v, spec, ctx) for k, v in prompts.items()}
    pad_to = text_len + gen
    if placed:
        front = token_split(cfg, prompt_len)[0]
        if cfg.enc_dec and pad_to != front:
            raise ValueError(f"the placed step's shape suite holds whisper's "
                             f"self and cross caches at one length: {pad_to} "
                             f"text rows against {front} encoder rows")
        suite = ShapeSuite("serve", pad_to + (front if cfg.vlm else 0),
                           batch, "decode")
        prefill = jit_prefill_step(model, pad_to=pad_to)
        decode = jit_decode_step(model, suite)
    else:
        prefill = functools.partial(model.prefill, pad_to=pad_to)
        decode = model.decode_step
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    cache, logits = prefill(params, prompts)
    tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_prefill = time.perf_counter() - t0

    sharding.reset_collective_stats(timed=True)
    out, tokens, lat = timed_decode_loop(
        decode, params, cache, tokens, steps=gen - 1,
        make_batch=lambda tokens, i: {"tokens": tokens})
    coll = sharding.collective_stats()
    sharding.reset_collective_stats()
    t_decode = sum(lat)
    generated = torch.cat(out, dim=1)
    for axis in reversed(batch_axes):
        generated = ctx.all_gather(generated, axis, dim=0)
    generated = generated.cpu()
    layers, moe = cache["layers"], params["layers"].get("moe", {})
    stats = {
        "engine": "dense",
        "layout": "placed" if placed else "held",
        "machine": get_machine().name,
        "device": str(dev),
        "mesh": mesh_stats(ctx),
        "generated_shape": tuple(generated.shape),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "decode_captures": 0,
        "held_bytes": {
            "params": tensor_bytes(params),
            "experts": sum(tensor_bytes(moe.get(k))
                           for k in ("w_gate", "w_up", "w_down")),
            "kv_cache": sum(tensor_bytes(layers.get(k)) for k in
                            ("k", "v", "cross_k", "cross_v")),
        },
        "kv_len": cache.get("kv_len", {}),
        "collectives": coll,
        "steps": gen - 1,
        "sample_tokens": generated[0, :8].tolist(),
        "substrate": guard.stats(),
        "generated": generated.tolist(),
    }
    if dev.type == "cuda":
        stats["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated(dev) / 1e9
    stats.update(latency_report(lat))
    return stats


def serve_placed(cfg, *, batch: int, prompt_len: int, gen: int,
                 ctx: ShardingCtx, seed: int = 0, device=None,
                 params=None) -> Dict[str, Any]:
    """The placed serving step on this rank of a running mesh, as the
    reference's dry-run places it: the parameters placed by their rules
    (`Model.param_shardings`; drawn from `seed` as `serve` draws them,
    each rank its blocks, unless `params` gives them), this rank's rows of
    the reference's prompts for `seed`, `runtime.steps.jit_prefill_step`
    (the caches come out placed by `Model.cache_shardings`), then
    ``gen - 1`` steps of `runtime.steps.jit_decode_step`. Runs on the GPU
    unless `device` names the mesh's CPU (never falling back: no CUDA
    device raises RuntimeError). Returns the stats of `_serve_mesh` with
    ``"layout": "placed"``."""
    if ctx.mesh is None:
        raise ValueError("serve_placed runs on a running mesh's ranks")
    return _serve_mesh(cfg, ctx, batch=batch, prompt_len=prompt_len,
                       gen=gen, seed=seed, device=device, params=params,
                       placed=True)


def _serve_rank(ctx: ShardingCtx, cfg, kwargs: Dict[str, Any]):
    """One rank of `serve_on_mesh`: `serve` under the rank's context, on
    the mesh's device type."""
    return serve(cfg, ctx=ctx, device=ctx.device.type, **kwargs)


def serve_on_mesh(cfg, shape: Sequence[int], *, device: str, backend: str,
                  layout: str = "default", timeout_s: Optional[float] = None,
                  **kwargs) -> List[Dict[str, Any]]:
    """`serve` on a ``(data, model)`` mesh of `shape`, one process a rank
    (`launch.mesh.spawn`, whose `device` and `backend` the caller names:
    two ranks that share a card need "gloo"). Returns every rank's stats,
    in rank order; raises unless every rank generated the same tokens
    (and, paged, left every request in the same state) and, dense, every
    request generated its `gen` of them."""
    from repro_torch.launch.mesh import DEFAULT_TIMEOUT_S, spawn
    from repro_torch.runtime.layouts import rules_for

    fn = functools.partial(_serve_rank, cfg=cfg,
                           kwargs=dict(kwargs, layout=layout))
    stats = spawn(fn, shape, device=device, backend=backend,
                  rules=rules_for(layout),
                  timeout_s=timeout_s or DEFAULT_TIMEOUT_S)
    want = (kwargs["batch"], kwargs["gen"])
    for r, st in enumerate(stats):
        if st["engine"] == "dense" and tuple(st["generated_shape"]) != want:
            raise RuntimeError(f"rank {r}: generated {st['generated_shape']}, "
                               f"wanted {want}")
        if st["generated"] != stats[0]["generated"] or \
                st.get("states") != stats[0].get("states"):
            raise RuntimeError(f"rank {r}'s tokens or requests' states "
                               f"differ from rank 0's")
    return stats


def serve_paged(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
                block_size: int = 16, num_blocks: Optional[int] = None,
                prefix_cache: bool = True, prefill_chunk: int = 32,
                deadline_s: Optional[float] = None,
                chaos: Optional[int] = None, device=None,
                params=None, max_in_flight: Optional[int] = None,
                ctx: ShardingCtx = NULL_CTX):
    """Continuous batching: `batch` requests with ragged prompt lengths
    (4x spread) through a block pool sized to force page reuse. Half the
    requests share a system-prompt prefix so the prefix cache (when on) has
    something to dedup. `deadline_s` bounds each request's wall clock;
    `chaos` seeds a deterministic fault schedule (serve.FaultInjector).
    `device` None means the GPU; `params` None draws random weights from
    `seed` on that device. The prompts are the reference package's for the
    same seed.

    With a `ctx` whose mesh runs, this serves on this rank of it (every
    rank calls it alike; `params`, when given, are this rank's) and the
    stats add the engine's mesh figures (`PagedServingEngine.stats`: the
    mesh, the bytes this rank holds, the collectives' calls, bytes and
    seconds, timed sync to sync, by rounds, chunks and lockstep) and, on
    the GPU, the rank's peak memory allocated."""
    from repro_torch import sharding
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
    eng = PagedServingEngine(cfg, ctx, block_size=block_size,
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
    on_card = eng.device.type == "cuda"
    if ctx.mesh is not None:
        sharding.reset_collective_stats(timed=True)
        if on_card:
            torch.cuda.reset_peak_memory_stats(eng.device)
    stats = eng.run()
    if ctx.mesh is not None:
        sharding.reset_collective_stats()
        if on_card:
            stats["max_memory_allocated_gb"] = \
                torch.cuda.max_memory_allocated(eng.device) / 1e9
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
                    help="serving: bf16 weight storage, row KV writes")
    ap.add_argument("--engine", default="dense", choices=["dense", "paged"],
                    help="dense: fixed batch, one cache per layer; paged: "
                         "continuous batching over a paged KV pool")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="share KV pages across common prompt prefixes "
                         "(--no-prefix-cache disables)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="tokens per chunked-prefill step (paged engine)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline in seconds; "
                         "expired requests are CANCELLED at the next round "
                         "boundary (paged engine)")
    ap.add_argument("--strict", action="store_true",
                    help="disable substrate degradation: any kernel "
                         "backoff or parity mismatch raises its typed "
                         "SubstrateError instead")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject a deterministic fault schedule seeded by "
                         "SEED (paged engine)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export the run's span trace as Chrome trace-event "
                         "JSON (open in https://ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on a (data, model) mesh, one process a "
                         "rank (either engine), e.g. 1x2; rank 0 prints")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's process-group backend (default: nccl "
                         "on the GPU, one card a rank; gloo on the CPU; "
                         "ranks sharing a card need gloo)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh

        device = "cuda" if args.device is None else args.device
        backend = args.backend or ("gloo" if device == "cpu" else "nccl")
        stats = serve_on_mesh(
            cfg, parse_mesh(args.mesh), device=device, backend=backend,
            layout=args.layout, batch=args.batch, prompt_len=args.prompt_len,
            gen=args.gen, seed=args.seed, strict=args.strict,
            engine=args.engine, block_size=args.block_size,
            num_blocks=args.num_blocks, prefix_cache=args.prefix_cache,
            prefill_chunk=args.prefill_chunk, deadline_s=args.deadline_s,
            chaos=args.chaos)[0]
        print(json.dumps(stats))
        return stats
    stats = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                  gen=args.gen, seed=args.seed, engine=args.engine,
                  block_size=args.block_size, num_blocks=args.num_blocks,
                  prefix_cache=args.prefix_cache,
                  prefill_chunk=args.prefill_chunk,
                  deadline_s=args.deadline_s, chaos=args.chaos,
                  device=args.device, strict=args.strict,
                  layout=args.layout)
    if args.trace:
        stats["trace"] = obs_trace.get_tracer().export(args.trace)
        stats["trace_events"] = len(obs_trace.get_tracer().events)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
