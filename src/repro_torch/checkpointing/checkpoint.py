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

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save",
           "to_numpy"]


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


class AsyncCheckpointer:
    """Fire-and-forget saves; at most one in flight (a newer save waits for
    the one before)."""

    def __init__(self, ckpt_dir, *, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, state, step: int):
        self.wait()
        host_state = tree.map_tree(to_numpy, state)  # snapshot before mutation

        def work():
            save(host_state, self.ckpt_dir, step, keep=self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None


def restore(ckpt_dir, template, *, step: Optional[int] = None) -> Any:
    """Restore into `template`'s tree structure: each tensor leaf comes back
    as a tensor of the template leaf's type on its device, any other leaf
    as a numpy array."""
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

    def take(i: int, like):
        a = data[f"leaf_{i}"]
        if not isinstance(like, torch.Tensor):
            return a
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"leaf_{i}: shape {a.shape} != {tuple(like.shape)}")
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=like.device, dtype=like.dtype)

    return tree.unflatten(template, [take(i, x) for i, x in enumerate(leaves)])


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(ckpt_dir.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
