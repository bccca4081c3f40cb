"""Training loop: steps + checkpoints + straggler monitor + exact resume
(the reference package's ``runtime/train_loop.py``). Every step goes
through `runtime.steps.jit_train_step`, the counterpart of the reference's
``jax.jit(step_fn, donate_argnums=(0,))``: on the card one captured CUDA
graph, replayed; on the CPU, and on every rank of a device mesh, the same
step run eagerly."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpointing.checkpoint import (AsyncCheckpointer,
                                                  latest_step, restore)
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, MarkovTask
from repro_torch.models.params import initialize
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.optim.compression import init_error_state
from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.runtime.steps import (held_state_specs, jit_train_step,
                                       local_batch)

__all__ = ["TrainReport", "train"]


@dataclasses.dataclass
class TrainReport:
    steps: int
    losses: Dict[int, float]
    resumed_from: Optional[int]
    straggler_steps: int
    wall_s: float
    step_s: List[float] = dataclasses.field(default_factory=list)
    held_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)


def train(model: Model, *, steps: int, data_cfg: DataConfig,
          opt: Optional[AdamWConfig] = None, accum: int = 1,
          compress_grads: bool = False, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10, seed: int = 0,
          fail_at_step: Optional[int] = None, device=None) -> TrainReport:
    """Run `steps` optimizer steps on `device` (CUDA unless the caller names
    another; RuntimeError where there is none); resumes exactly from
    `ckpt_dir` if it holds a checkpoint. Parameters are drawn from a
    `torch.Generator` on the device seeded with `seed`; batches are the
    Markov task's for each step, copied into the step's buffers.

    `fail_at_step` injects a crash (fault-tolerance tests and demos).
    `TrainReport.step_s` holds each step's time, the device synchronized
    at its end; on the card the first step (of this call) is the eager
    step and the capture, every later one a replay. With
    `compress_grads`, as in the reference, the whole batch is one
    microbatch (`accum` is not used).

    On a model whose `ctx` holds a running mesh (every rank of
    `launch.mesh.spawn` calls `train`) the loop runs on the mesh's device
    (`device`, if given, must be its type): each rank draws every leaf
    whole on the CPU from `seed` (a CUDA generator draws other numbers, so
    the card's mesh and the CPU's start alike) and keeps its share on its
    device, takes its rows of each global batch (`steps.local_batch`),
    and logs the global loss, the same on every rank. A checkpoint holds
    the whole state (rank 0 writes it) and a resume gives each rank its
    share, whatever mesh wrote it."""
    from repro_torch.serve.engine import resolve_device

    t_start = time.time()
    ctx = model.ctx
    if ctx.mesh is None:
        device = resolve_device(device)
    else:
        ctx._running()
        if device is not None and torch.device(device).type != \
                ctx.device.type:
            raise ValueError(f"the mesh's ranks run on {ctx.device.type}, "
                             f"not {device}")
        device = ctx.device
    opt = opt or AdamWConfig(total_steps=steps)
    task = MarkovTask(data_cfg)
    accum = 1 if compress_grads else accum

    # the step is dropped on return, and the graph's memory pool with it
    step_fn = jit_train_step(model, opt, accum=accum,
                             compress=compress_grads)

    # ---- init or resume
    resumed_from = None
    gen = torch.Generator(device=device if ctx.mesh is None else "cpu")
    gen.manual_seed(seed)
    if ctx.mesh is None:
        params = model.init(gen, device)
    else:
        params = tree.map_tree(lambda p: p.to(device), model.place(
            initialize(model.param_specs(), gen, "cpu")))
    state = init_state(params)
    if compress_grads:
        state["grad_error"] = init_error_state(params)
    specs = held_state_specs(model, state) if ctx.mesh is not None else None
    if ckpt_dir is not None and latest_step(ckpt_dir) is not None:
        resumed_from = latest_step(ckpt_dir)
        state = restore(ckpt_dir, state, ctx=ctx, specs=specs)

    ckpt = AsyncCheckpointer(ckpt_dir, ctx=ctx, specs=specs) \
        if ckpt_dir is not None else None
    monitor = StragglerMonitor()
    losses: Dict[int, float] = {}
    step_s: List[float] = []

    start = int(state["step"])
    for step in range(start, steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = local_batch(ctx, {k: torch.as_tensor(v) for k, v in
                                  task.batch_for_step(step).items()}, accum)
        with monitor.timed() as timer:
            state, metrics = step_fn(state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        step_s.append(timer.elapsed)
        # `metrics` are the graph's outputs and `state` its donated buffers,
        # both rewritten by the next replay: the loss is read and the
        # checkpoint's host copy taken (on this thread) before it
        if step % log_every == 0 or step == steps - 1:
            losses[step] = float(metrics["loss"])
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save_async(state, step + 1)
    if ckpt is not None:
        ckpt.save_async(state, steps)
        ckpt.wait()
    held = {k: sum(x.numel() * x.element_size() for x in tree.leaves(v))
            for k, v in state.items() if k != "step"}
    return TrainReport(steps=steps, losses=losses, resumed_from=resumed_from,
                       straggler_steps=len(monitor.flagged),
                       wall_s=time.time() - t_start, step_s=step_s,
                       held_bytes=held)
