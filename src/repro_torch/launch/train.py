"""Training launcher (the reference package's ``launch/train.py``).

Picks an arch (reduced or custom dims), builds the Markov data task, and
runs the fault-tolerant train loop: on one device, the GPU unless
``--device cpu`` is given (RuntimeError where there is no GPU); or on a
device mesh, one process a rank (`launch.mesh.spawn`): ``--mesh mini``,
the reference's mini mesh of ``--ranks`` processes (``(ranks / 2, 2)``
when the count is even, else ``(ranks, 1)``; the reference takes its rank
count from its devices, processes are named by the caller here, 2 by
default), or ``--mesh DATAxMODEL`` (e.g. ``2x1``). On a mesh each rank
holds its block of params, mu and nu placed by their rules, and a line
is printed for each rank with the bytes it holds of each. ``--backend``
is the process group's: ``gloo`` on the CPU, ``nccl`` (the default) for
one card a rank; ranks that share a card ask for ``gloo``, and NCCL with
more ranks than cards raises. The run has no time limit; each collective
has `spawn`'s. Rank 0's report is printed last.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --reduced --device cpu --steps 100 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --reduced --mesh mini --ranks 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --reduced --mesh 2x1 --device cpu --backend gloo
"""
from __future__ import annotations

import argparse
import functools
import json

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import train
from repro_torch.sharding import NULL_CTX, ShardingCtx


def _run(ctx: ShardingCtx, args, cfg):
    """The loop on one device (`NULL_CTX`), or on one rank of the mesh
    `ctx` runs."""
    model = build_model(cfg, ctx)
    if ctx.mesh is None or not any(ctx.mesh.coordinate):
        print(f"arch={cfg.name} params={model.n_params()/1e6:.1f}M "
              f"layers={cfg.n_layers} d_model={cfg.d_model}", flush=True)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    return train(
        model, steps=args.steps, data_cfg=data_cfg,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5)),
        accum=args.accum, compress_grads=args.compress_grads,
        ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at,
        device=args.device if ctx.mesh is None else None,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash (fault-tolerance demo)")
    ap.add_argument("--mesh", default="none", metavar="none|mini|DATAxMODEL")
    ap.add_argument("--ranks", type=int, default=2,
                    help="--mesh mini's processes, one a rank (default 2)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's process-group backend (default: nccl "
                         "on cuda, gloo on cpu)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model,
                    n_heads=max(args.d_model // 64, 1),
                    kv_heads=max(args.d_model // 128, 1),
                    d_ff=args.d_model * 4, head_dim=0)
    if args.layers:
        over["n_layers"] = args.layers
    if args.vocab:
        over["vocab"] = args.vocab
    if over:
        cfg = cfg.replace(**over)

    if args.mesh != "none":
        from repro_torch.launch.mesh import mesh_by_name, parse_mesh, spawn
        from repro_torch.serve.engine import resolve_device

        if args.mesh == "mini":
            mesh = mesh_by_name("mini", devices=args.ranks)
            shape, names = mesh.shape, mesh.axis_names
        else:
            shape, names = parse_mesh(args.mesh), ("data", "model")
        device = resolve_device(args.device).type
        reports = spawn(functools.partial(_run, args=args, cfg=cfg),
                        shape, axis_names=names, device=device,
                        backend=args.backend or ("gloo" if device == "cpu"
                                                 else "nccl"),
                        deadline=False)
        for rank, rep in enumerate(reports):
            print(json.dumps({"rank": rank, "mesh": list(shape),
                              "held_bytes": rep.held_bytes}))
        report = reports[0]
    else:
        report = _run(NULL_CTX, args, cfg)
    first = min(report.losses)
    last = max(report.losses)
    print(json.dumps({
        "steps": report.steps,
        "loss_first": report.losses[first],
        "loss_last": report.losses[last],
        "resumed_from": report.resumed_from,
        "stragglers": report.straggler_steps,
        "wall_s": round(report.wall_s, 1),
    }))
    return report


if __name__ == "__main__":
    main()
