"""Dry-run: what one step costs each rank at the production shapes (the
reference package's ``launch/dryrun.py``).

For each (arch x shape x mesh) cell the step the reference compiles is
built as the port runs it on a mesh, for rank 0 of a dry mesh
(`sharding.dry_mesh`: a coordinate and no processes), and run once on meta
tensors inside a `roofline.StepCounter`: no memory is allocated on any
device, no kernel is built or launched (each wrapper's meta route records
its cost), and no process is started. It needs neither a GPU nor nvcc,
and runs on the CPU of any machine.

The steps (`_build_step`) and rank 0's inputs:

  * train: `runtime.steps.make_train_step` (the functional step, on the
    placed blocks: each layer's leaves gathered over ``data`` inside its
    remat and again in the recompute, attention, the MLP, the logits and
    the loss tensor-parallel over ``model``, the gather's backward
    reduce-scattering each gradient into its block, an all_reduce over
    the axes that do not place a leaf, AdamW); the state placed by its
    rules (`Model.place`: params, mu, nu), the batch's rows
    (`local_batch`'s cut). Layout ``"placed"``;
  * prefill: `make_prefill_step` (`runtime.steps.
    jit_prefill_step`'s step); the parameters placed by their rules
    (`Model.place`, the reference's ``param_shardings``), the batch's rows;
    the cache comes out placed (``cache_shardings``). Layout ``"placed"``;
  * decode: `make_decode_step` (`jit_decode_step`'s step); the placed
    parameters, the rank's blocks of the cache placed by
    ``cache_shardings`` (`Model.place_cache`), the batch's rows. Layout
    ``"placed"``.

Every step on the placed layout gathers each layer's leaves over
``data`` just before the layer and runs attention and the MLP
tensor-parallel over ``model`` (`models.lm`), as the reference's placed
steps are partitioned; no rank holds the whole parameters.

A trace sees every layer, so the counts are of the full depth, exactly
(``depth_info.mode`` ``"traced_full_depth"``; ``--full-unroll`` gives the
same record). `_extrapolate` and `DEPTHS` are kept as the reference has
them, for checking that the counts are linear in depth. The record holds
the reference's keys (`run_cell`) and ``"counted_by": "traced"``,
``"layout"``, the collectives' calls by kind, the kernels' calls, FLOPs and
bytes, and the leaves a rule would split but the divisibility guard left
whole on every rank. The machine terms read `core.machine.get_machine()`
(``h100`` unless ``REPRO_MACHINE`` says otherwise).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --jobs 8

``--mesh mini`` is the reference's mini mesh over ``REPRO_DRYRUN_DEVICES``
ranks (512 when unset, as the reference forces 512 host devices).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch import roofline
from repro_torch.configs import ALL_ARCH_NAMES, get_config
from repro_torch.configs.shapes import (ALL_SHAPE_NAMES, SHAPES,
                                        batch_specs, cell_supported,
                                        decode_batch_specs)
from repro_torch.core import tree
from repro_torch.core.machine import get_machine
from repro_torch.launch.mesh import mesh_by_name
from repro_torch.models import build_model
from repro_torch.models.params import is_spec
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.sharding import ShardingCtx, dry_mesh

__all__ = ["DEPTHS", "main", "run_cell", "trace_step"]

DEPTHS = (2, 6)


def _mesh(name: str):
    if name.startswith("mini"):
        return mesh_by_name(name, int(os.environ.get("REPRO_DRYRUN_DEVICES",
                                                     "512")))
    return mesh_by_name(name)


def _rows(specs, ctx: ShardingCtx, accum: int = 1) -> Dict[str, torch.Tensor]:
    """Rank 0's rows of a batch of `specs` (`steps.local_batch`'s cut:
    each of `accum` microbatches split over ``batch``'s axes)."""
    out = {}
    for k, v in specs.items():
        shape = (v.shape[0] // accum,) + tuple(v.shape[1:])
        spec = ctx.spec(["batch"] + [None] * (len(shape) - 1), shape)
        rows = shape[0] // ctx.axis_size(spec[0]) if spec else shape[0]
        out[k] = torch.empty((rows * accum,) + shape[1:], dtype=v.dtype,
                             device="meta")
    return out


def _guard_whole(model) -> list:
    """The parameter leaves a rule would split that the divisibility guard
    keeps whole (on every rank alike)."""
    ctx = model.ctx
    out = []
    for path, s in tree.paths(model.param_specs()):
        if is_spec(s) and ctx.spec(s.axes) != ctx.spec(s.axes, s.shape):
            out.append("/".join(path))
    return out


def _build_step(cfg, shape, mesh, rules=None, accum=1):
    """(model, fn, args, layout) for one cell: rank 0's step on the dry
    mesh and its meta inputs."""
    ctx = ShardingCtx(mesh=dry_mesh(mesh), rules=rules)
    model = build_model(cfg, ctx)
    kind = shape.kind
    if kind == "train":
        fn = make_train_step(model, AdamWConfig(), accum=accum)
        state = {"step": torch.empty((), dtype=torch.int32, device="meta")}
        for key in ("params", "mu", "nu"):
            state[key] = model.place(model.abstract_params())
        args = (state, _rows(batch_specs(cfg, shape), ctx, accum))
        return model, fn, args, "placed"
    params = model.place(model.abstract_params())
    if kind == "prefill":
        fn = make_prefill_step(model)
        return model, fn, (params, _rows(batch_specs(cfg, shape), ctx)), \
            "placed"
    fn = make_decode_step(model)
    cache = model.place_cache(model.abstract_cache(shape))
    return model, fn, (params, cache, _rows(decode_batch_specs(cfg, shape),
                                            ctx)), "placed"


def trace_step(fn, args) -> Dict[str, Any]:
    """Run `fn(*args)` once on meta tensors inside a `StepCounter`: its
    FLOPs, bytes, memory, collectives and kernels, the trace's seconds,
    and the counter itself (``"counter"``)."""
    t0 = time.perf_counter()
    with roofline.StepCounter(args) as sc:
        out = fn(*args)
    memory = sc.finish(out)
    del out
    return {"flops": sc.flops, "bytes": sc.bytes,
            "hbm": roofline.hbm_bytes(sc), "memory": memory,
            "collectives": roofline.collective_bytes(sc),
            "collective_calls": dict(sc.collective_calls),
            "kernels": sc.kernels, "t_trace": time.perf_counter() - t0,
            "counter": sc}


def _trace(cfg, shape, mesh, rules=None, accum=1):
    model, fn, args, layout = _build_step(cfg, shape, mesh, rules, accum)
    out = trace_step(fn, args)
    out.update(model=model, layout=layout)
    return out


def _depth_override(cfg, n: int):
    kw = {"n_layers": n, "scan_layers": False}
    if cfg.enc_dec:
        kw["n_enc_layers"] = n
    return cfg.replace(**kw)


def _extrapolate(c2: dict, c6: dict, L: int):
    """Linear-in-depth reconstruction: cost(L) = c2 + (L-2)/(6-2) * (c6-c2)."""
    f = (L - 2) / 4.0

    def lin(a, b):
        return max(a + f * (b - a), 0.0)

    coll_types = set(c2["collectives"]) | set(c6["collectives"])
    coll = {
        k: int(lin(c2["collectives"].get(k, 0), c6["collectives"].get(k, 0)))
        for k in coll_types
    }
    return {
        "flops": lin(c2["flops"], c6["flops"]),
        "bytes": lin(c2["bytes"], c6["bytes"]),
        "hbm": lin(c2["hbm"], c6["hbm"]),
        "collectives": coll,
    }


def _write(rec: dict, out_dir) -> None:
    if out_dir is None:
        return
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))


def run_cell(arch: str, shape_name: str, mesh_name: str, *, out_dir=None,
             overrides=None, rules=None, accum=1, verbose=True,
             full_unroll=False):
    """Trace one (arch x shape x mesh) cell; return its roofline record.

    The step runs once, at full depth, on rank 0 of the dry mesh (the
    module docstring): the counts are exact for the port's program, so
    `full_unroll` changes nothing. A cell that `cell_supported` refuses is
    ``skipped`` with its reason."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, why = cell_supported(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(rec, out_dir)
        return rec

    if overrides:
        cfg = cfg.replace(**overrides)
    mesh = _mesh(mesh_name)
    n_chips = mesh.size
    kind = shape.kind
    del full_unroll                   # a trace is the full depth already

    est = _trace(cfg.replace(scan_layers=False), shape, mesh, rules, accum)
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] traced in "
              f"{est['t_trace']:.1f}s")
        print("  memory:", est["memory"])

    machine = get_machine()
    t = roofline.terms(est["flops"], est["bytes"], est["collectives"],
                       machine=machine)
    mflops = roofline.model_flops(cfg, shape, kind)
    rec.update(
        status="ok",
        machine=machine.name,
        kind=kind,
        chips=int(n_chips),
        counted_by="traced",
        layout=est["layout"],
        compile_s=round(est["t_trace"], 2),
        memory=est["memory"],
        hlo_flops_per_chip=est["flops"],
        hlo_bytes_per_chip=est["bytes"],
        hbm_bytes_per_chip=est["hbm"],
        memory_hbm_s=est["hbm"] / machine.hbm_bw,
        collective_bytes=est["collectives"],
        collective_calls=est["collective_calls"],
        kernels=est["kernels"],
        guard_whole=_guard_whole(est["model"]),
        terms=t,
        dominant=roofline.dominant(t),
        model_flops_total=mflops,
        model_flops_per_chip=mflops / n_chips,
        useful_flops_ratio=(mflops / n_chips) / est["flops"]
        if est["flops"] else 0.0,
        depth_info={"mode": "traced_full_depth", "layers": cfg.n_layers},
    )
    if verbose:
        print("  est: flops=%.3e bytes=%.3e hbm=%.3e coll=%s"
              % (est["flops"], est["bytes"], est["hbm"], est["collectives"]))
        print("  terms: compute=%.3es memory=%.3es collective=%.3es "
              "dominant=%s" % (t["compute_s"], t["memory_s"],
                               t["collective_s"], rec["dominant"]))
        print("  useful_flops_ratio=%.3f" % rec["useful_flops_ratio"])
    _write(rec, out_dir)
    return rec


def _cell(job):
    """One cell of `main`'s sweep: (the record, the traceback or None)."""
    arch, shape, mesh, kw = job
    try:
        return run_cell(arch, shape, mesh, **kw), None
    except Exception as e:  # record and continue
        rec = {"arch": arch, "shape": shape, "mesh": mesh,
               "status": "error", "error": repr(e)}
        _write(rec, kw.get("out_dir"))
        return rec, traceback.format_exc()


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape id or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "mini", "both"])
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. remat=False)")
    ap.add_argument("--rule", action="append", default=[],
                    help="sharding rule override logical=mesh_axis|none")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--full-unroll", action="store_true",
                    help="the same record: a trace is the full depth")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v) if v not in ("True", "False") \
            else (v == "True")
    rules = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        rules[k] = None if v in ("none", "None") else v

    archs = list(ALL_ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(ALL_SHAPE_NAMES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    kw = dict(out_dir=args.out, overrides=overrides or None,
              rules=rules or None, accum=args.accum,
              full_unroll=args.full_unroll, verbose=args.jobs == 1)
    jobs = [(a, s, m, kw) for a in archs for s in shapes for m in meshes]
    # the longest traces first (prefill, then train), so that a pool's
    # last cells are short ones
    jobs.sort(key=lambda j: ("prefill" not in j[1], "train" not in j[1]))

    if args.jobs > 1:
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            results = list(pool.map(_cell, jobs))
    else:
        results = [_cell(job) for job in jobs]
    failures = []
    for rec, tb in results:
        tag = f"[{rec['arch']} x {rec['shape']} x {rec['mesh']}]"
        if rec["status"] == "skipped":
            print(f"{tag} SKIPPED: {rec['reason']}")
        elif rec["status"] == "error":
            print(tb)
            failures.append((rec["arch"], rec["shape"], rec["mesh"],
                             rec["error"]))
        elif args.jobs > 1:
            print(f"{tag} ok {rec['dominant']} useful "
                  f"{rec['useful_flops_ratio']:.3f} traced "
                  f"{rec['compile_s']} s")
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("dry-run complete: all cells OK")


if __name__ == "__main__":
    main()
