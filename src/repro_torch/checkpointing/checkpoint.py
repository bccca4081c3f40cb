"""Atomic, async checkpoints of a state tree (the reference package's
``checkpointing/checkpoint.py``, on its on-disk layout).

Layout: ``<dir>/step_%08d/{meta.json, arrays.npz}``, committed by renaming
a tmp dir (a partially written checkpoint is never visible); the newest
`keep` are kept. ``leaf_i`` is the i-th leaf in the order in which
``jax.tree.flatten`` walks a nested dict (keys sorted, depth first:
`core.tree`), so a checkpoint written by either package restores into the
other's template. `restore` relies on the template alone (its structure,
and each leaf's type and device), not on the ``treedef`` string.
`AsyncCheckpointer.save_async` copies the state to host memory on the
caller's thread and writes it on another, so the train loop keeps
stepping. bfloat16 leaves are stored as float32 (numpy has no bfloat16)
and come back exactly.

On a device mesh (a `ShardingCtx` whose mesh runs, and `specs`: a tree of
partition specs of the state's structure, what each rank holds: the train
state's placed specs, `runtime.steps.held_state_specs`) a checkpoint holds
the whole state in the single-device layout: every rank gathers its split
leaves over the axes that split them, and rank 0 alone writes; `restore`
gives each rank its block of every leaf. A checkpoint is the same files whatever mesh, or
none, wrote it, and restores onto any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree
from repro_torch.sharding import NULL_CTX, ShardingCtx, local_shard

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save",
           "to_numpy", "whole_state"]


def to_numpy(x) -> np.ndarray:
    """A host copy of a leaf (a tensor on any device, or an array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save(state, ckpt_dir, step: int, *, keep: int = 3) -> Path:
    """Blocking atomic save. Returns the committed directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    keyed = list(tree.paths(state))
    arrays = {f"leaf_{i}": to_numpy(x) for i, (_, x) in enumerate(keyed)}
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {
        "step": step,
        "n_leaves": len(keyed),
        "treedef": str(["/".join(path) for path, _ in keyed]),
        "time": time.time(),
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    final = ckpt_dir / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gather(x: torch.Tensor, spec, ctx: ShardingCtx) -> torch.Tensor:
    """A rank's block of a leaf -> the whole leaf (on every rank)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = ctx.all_gather(x, entry, dim=dim)
    return x


def whole_state(state, specs, ctx: ShardingCtx):
    """Every rank's share of a state -> the whole state, on every rank of
    the mesh (a collective: every rank calls it): each split leaf gathered
    over the axes that split it, each whole leaf as it is."""
    with torch.no_grad():
        return tree.map_tree(lambda x, spec: _gather(x, spec, ctx) if spec
                             else x, state, specs)


class AsyncCheckpointer:
    """Fire-and-forget saves; at most one in flight (a newer save waits for
    the one before). On a mesh (`ctx`, and the state's held `specs`) every
    rank calls `save_async` and `wait`: the whole state is gathered on the
    caller's thread, rank 0 writes it, and `wait` ends at a barrier, so
    that no rank reads the directory before the writer is done."""

    def __init__(self, ckpt_dir, *, keep: int = 3,
                 ctx: ShardingCtx = NULL_CTX, specs=None):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self.ctx, self.specs = ctx, specs
        self._thread: Optional[threading.Thread] = None

    def save_async(self, state, step: int):
        self.wait()
        if self.ctx.mesh is not None:
            state = whole_state(state, self.specs, self.ctx)
            if any(self.ctx.mesh.coordinate):
                return                      # rank 0 writes
        host_state = tree.map_tree(to_numpy, state)  # snapshot before mutation

        def work():
            save(host_state, self.ckpt_dir, step, keep=self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.ctx.mesh is not None:
            import torch.distributed as dist
            dist.barrier()


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def restore(ckpt_dir, template, *, step: Optional[int] = None,
            ctx: ShardingCtx = NULL_CTX, specs=None) -> Any:
    """Restore into `template`'s tree structure: each tensor leaf comes back
    as a tensor of the template leaf's type on its device, any other leaf
    as a numpy array. On a mesh the template is a rank's blocks and `specs`
    their partition specs: each leaf is read whole and this rank keeps its
    block (`local_shard`)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    data = np.load(d / "arrays.npz")
    leaves = tree.leaves(template)
    if len(leaves) != len(data.files):
        raise ValueError(f"checkpoint has {len(data.files)} leaves, the "
                         f"template {len(leaves)} (arch changed?)")
    held = tree.leaves(specs) if ctx.mesh is not None else [()] * len(leaves)

    def take(i: int, like, spec):
        a = data[f"leaf_{i}"]
        if not isinstance(like, torch.Tensor):
            return a
        x = torch.from_numpy(np.array(a, copy=True))
        if spec:
            x = torch.clone(local_shard(x, spec, ctx),
                            memory_format=torch.contiguous_format)
        if tuple(x.shape) != tuple(like.shape):
            raise ValueError(f"leaf_{i}: shape {a.shape} (held {tuple(x.shape)})"
                             f" != {tuple(like.shape)}")
        return x.to(device=like.device, dtype=like.dtype)

    return tree.unflatten(template, [take(i, x, spec) for i, (x, spec)
                                     in enumerate(zip(leaves, held))])


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(ckpt_dir.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
