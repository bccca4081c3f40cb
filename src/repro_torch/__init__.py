"""PyTorch + CUDA port of the CoroAMU reproduction, for NVIDIA Hopper.

A second package beside the JAX reference (`src/repro/`), with the same
layout and module names. Entry points run on the GPU unless the caller asks
for the CPU (``device="cpu"``), where every kernel wrapper runs its plain
PyTorch version instead of its CUDA kernel.
"""
from __future__ import annotations


def reset() -> None:
    """Reset the process-wide state of the port: autotune samples, depth
    decisions and config quarantine, the active machine profile (from
    ``REPRO_MACHINE``), the tracer and metrics registry (from
    ``REPRO_TELEMETRY``), the guard (its counters and ladders, strict mode
    off, the sentinel from ``REPRO_PARITY``, no injector), the kernels'
    launch counts, the step graphs' capture and replay counts and the
    collectives' counts. Tests call this between cases."""
    from repro_torch import obs, sharding
    from repro_torch.core import autotune, guard, step_graph
    from repro_torch.core.machine import set_machine
    from repro_torch.kernels import reset_launch_counts

    autotune.clear_samples()
    set_machine(None)
    obs.reset()
    guard.reset()
    reset_launch_counts()
    step_graph.reset()
    sharding.reset_collective_stats()


__all__ = ["reset"]
