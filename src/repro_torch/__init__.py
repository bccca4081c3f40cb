"""PyTorch + CUDA port of the CoroAMU reproduction, for NVIDIA Hopper.

A second package beside the JAX reference (`src/repro/`), with the same
layout and module names. Entry points run on the GPU unless the caller asks
for the CPU (``device="cpu"``), where every kernel wrapper runs its plain
PyTorch version instead of its CUDA kernel.
"""
from __future__ import annotations


def reset() -> None:
    """Reset the process-wide state of the port: autotune samples and
    quarantine, the active machine profile (from ``REPRO_MACHINE``), the
    tracer and metrics registry (from ``REPRO_TELEMETRY``), the substrate
    counters and the kernels' launch counts. Tests call this between cases."""
    from repro_torch import obs
    from repro_torch.core import autotune, guard
    from repro_torch.core.machine import set_machine
    from repro_torch.kernels import reset_launch_counts

    autotune.clear_samples()
    set_machine(None)
    obs.reset()
    guard.reset()
    reset_launch_counts()


__all__ = ["reset"]
