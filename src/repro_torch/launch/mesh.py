"""Meshes: their shapes, and the processes that run one.

`make_production_mesh` and `make_mini_mesh` give the reference package's
mesh shapes (``launch/mesh.py``) as `sharding.Mesh` objects, usable for
specs without any device. `spawn` runs a function on a mesh: the torch
counterpart of JAX's single controller over many devices is one process a
rank, each with its process group, its ``torch.distributed``
`DeviceMesh` (``("data", "model")``) and its device, ``cuda:{rank %
device_count}`` on the GPU.

The backend is named by the caller: ``nccl`` for one card a rank, ``gloo``
for the CPU. NCCL refuses two ranks on one card, so ranks that share a
card ask for ``gloo`` by name, which moves CUDA tensors through the host:
such a mesh checks the sharded arithmetic and the kernels at their
per-shard shapes, not the speed of a mesh of cards. NCCL with more ranks
than cards raises; it is never swapped for gloo.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.sharding import Mesh, ShardingCtx

__all__ = ["make_mini_mesh", "make_production_mesh", "mesh_by_name",
           "parse_mesh", "spawn"]

DEFAULT_TIMEOUT_S = 600.0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """One pod, 16 x 16 = 256 chips; or 2 pods x 256 with data parallelism
    extended over the `pod` axis."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mini_mesh(devices: int = 8, model: int = 2) -> Mesh:
    """A small ``(devices // model, model)`` mesh for sharded tests."""
    return Mesh(("data", "model"), (devices // model, model))


def mesh_by_name(name: str, devices: Optional[int] = None) -> Mesh:
    """``single``, ``multi``, or ``mini*``: `devices` ranks (None: the
    running process group's world size, else 1) with ``model = 2`` when
    that is even, else 1, as the reference picks from its device count."""
    if name == "single":
        return make_production_mesh(multi_pod=False)
    if name == "multi":
        return make_production_mesh(multi_pod=True)
    if name.startswith("mini"):
        if devices is None:
            import torch.distributed as dist
            devices = dist.get_world_size() if dist.is_initialized() else 1
        model = 2 if devices % 2 == 0 else 1
        return make_mini_mesh(devices, model)
    raise ValueError(f"unknown mesh {name!r}")


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"1x2"`` -> (data 1, model 2)."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"a mesh is DATAxMODEL, e.g. 1x2; got {text!r}")
    return int(parts[0]), int(parts[1])


def _rank_main(fn, rank: int, shape: Tuple[int, ...],
               axis_names: Tuple[str, ...], device: str, backend: str,
               rules, store: str, out_dir: str, timeout_s: float,
               threads: int) -> None:
    """One rank: its device, its process group and DeviceMesh, then
    ``fn(ctx)``, whose value goes to ``rank{r}.pt`` and whose exception's
    traceback to ``rank{r}.err`` (the process then exits 1 at once,
    leaving the other ranks to the parent)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = math.prod(shape)
    try:
        torch.set_num_threads(threads)
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        dm = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
        mesh = Mesh(axis_names, shape, device_mesh=dm,
                    coordinate=tuple(int(c) for c in dm.get_coordinate()),
                    device=dev)
        out = fn(ShardingCtx(mesh=mesh, rules=rules))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - reported to the parent
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)   # at once: the other ranks may wait in a collective


def _failures(out_dir: str, codes: Sequence[Optional[int]]) -> str:
    """Every failed rank's traceback, the first written first (a rank that
    raises can make the ranks waiting on it in a collective fail too)."""
    found = []
    for r, code in enumerate(codes):
        err = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                found.append((os.path.getmtime(err), r, f.read()))
        elif code not in (None, 0):
            found.append((math.inf, r, f"exit code {code}\n"))
    return "".join(f"rank {r} failed:\n{text}"
                   for _, r, text in sorted(found))


def spawn(fn: Callable[[ShardingCtx], Any], shape: Sequence[int], *,
          device: str, backend: str,
          axis_names: Sequence[str] = ("data", "model"),
          rules: Optional[Dict[str, Any]] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S,
          deadline: bool = True) -> List[Any]:
    """Run ``fn(ctx)`` on every rank of a mesh of `shape`, one process a
    rank; returns each rank's value, in rank order (values come back
    through ``torch.save``: keep them on the CPU).

    `fn` must be picklable (a module-level function, or a
    `functools.partial` of one). `device` is ``"cuda"`` (rank r on card
    ``r % device_count``) or ``"cpu"``; `backend` ``"nccl"`` or
    ``"gloo"``, named by the caller: NCCL with more ranks than cards, or on
    the CPU, raises ValueError. `timeout_s` bounds each of the process
    group's collectives and, with `deadline` (the default), the whole run
    too: a rank that raises, or a run past the limit, stops every rank and
    raises RuntimeError (with the failing rank's traceback) or
    TimeoutError. Nothing hangs. Without `deadline` the run takes as long
    as it takes (a training run), and a collective that waits past
    `timeout_s` still fails it."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    world = math.prod(shape)
    if len(shape) != len(axis_names) or world < 1:
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device is cuda or cpu, got {device!r}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend is nccl or gloo, got {backend!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh runs on the GPU unless "
                           "asked for the CPU (device=\"cpu\")")
    if backend == "nccl":
        cards = torch.cuda.device_count() if device == "cuda" else 0
        if world > cards:
            raise ValueError(
                f"nccl needs one card a rank: {world} ranks, {cards} cards "
                f"(ranks that share a card need backend=\"gloo\")")
    threads = max(1, torch.get_num_threads() // world)
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="repro_mesh_")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, shape, axis_names, device, backend, rules, store, out_dir,
        timeout_s, threads)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + timeout_s if deadline else math.inf
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                raise TimeoutError(f"mesh {shape}: ranks still running after "
                                   f"{timeout_s:.0f} s")
            time.sleep(0.05)
        if failed:
            raise RuntimeError(f"mesh {shape}: " + _failures(out_dir, codes))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
