"""Kernel-substrate errors, the always-on output scan and fault injection.

This is the part of the guarded-substrate layer the serving path needs:

* **Error taxonomy** — `SubstrateError` (kernel name, machine profile,
  depth, tile shape) with four concrete classes: `KernelCompileError`
  (build / launch failures), `KernelResourceError` (out of device or shared
  memory), `KernelNumericsError` (non-finite outputs) and
  `KernelParityError` (kernel against its plain version).
* **Always-on scan** — `scan_output` returns a `KernelNumericsError` when
  a floating tensor of an output holds NaN/Inf.
* **Fault injection** — `check_injected` fires a `serve.faults`-style
  injector's ``kernel_compile`` / ``kernel_oom`` / ``kernel_nan`` streams
  at engine call sites and raises the matching typed error.

There is deliberately no depth-backoff ladder that ends in a fallback and
no breaker that routes around a kernel: on a CUDA tensor a kernel wrapper
launches its kernel or raises, so a broken kernel can never be hidden
behind its plain version. `stats()` reports plain-int totals that survive
``REPRO_TELEMETRY=0``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "KernelCompileError",
    "KernelNumericsError",
    "KernelParityError",
    "KernelResourceError",
    "SubstrateError",
    "check_injected",
    "reset",
    "scan_output",
    "stats",
]


# ---------------------------------------------------------------- taxonomy


class SubstrateError(RuntimeError):
    """A kernel-substrate failure with its launch context attached."""

    def __init__(self, message: str, *, kernel: str = "?",
                 machine: Optional[str] = None, depth: Optional[int] = None,
                 tile: Optional[Tuple[int, ...]] = None):
        if machine is None:
            from repro_torch.core.machine import get_machine
            machine = get_machine().name
        super().__init__(
            f"{message} [kernel={kernel} machine={machine} depth={depth} "
            f"tile={tile}]")
        self.kernel = kernel
        self.machine = machine
        self.depth = depth
        self.tile = tile


class KernelCompileError(SubstrateError):
    """Build, load or launch failure (or an injected stand-in)."""


class KernelResourceError(SubstrateError):
    """Out of device memory or shared memory at the attempted depth."""


class KernelNumericsError(SubstrateError):
    """Non-finite values in a kernel's output (the always-on scan)."""


class KernelParityError(SubstrateError):
    """A kernel's output diverged from its plain version."""


# ------------------------------------------------------------ module state

_COUNT_KEYS = ("numerics_faults", "injected_faults")

_lock = threading.Lock()
_counts: Dict[str, int] = {}


def reset() -> None:
    """Zero the counters (test isolation: `repro_torch.reset()`)."""
    with _lock:
        _counts.clear()
        _counts.update({k: 0 for k in _COUNT_KEYS})


reset()


def stats() -> Dict[str, Any]:
    """Plain-int substrate totals (process-wide; survives
    ``REPRO_TELEMETRY=0``)."""
    with _lock:
        return {k: _counts.get(k, 0) for k in _COUNT_KEYS}


def _count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    from repro_torch.obs import metrics
    metrics.default_registry().counter(f"substrate.{name}").inc(n)


# -------------------------------------------------------- output policing


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x)


def scan_output(kernel: str, out: Any, *,
                depth: Optional[int] = None) -> Optional[KernelNumericsError]:
    """The always-on NaN/Inf scan: returns a `KernelNumericsError` if any
    floating tensor in `out` (a tensor or a nest of them) is non-finite,
    else None. Reading the verdict waits for the device."""
    for t in _tensors(out):
        if not t.is_floating_point():
            continue
        if not bool(torch.isfinite(t).all()):
            _count("numerics_faults")
            from repro_torch.obs import trace
            trace.get_tracer().instant("substrate_nonfinite",
                                       tid=trace.TID_KERNEL, kernel=kernel,
                                       depth=depth)
            return KernelNumericsError(
                "non-finite values in kernel output", kernel=kernel,
                depth=depth)
    return None


# --------------------------------------------------------- fault injection


def check_injected(kernel: str, injector: Any, **ctx: Any) -> None:
    """Fire the kernel-site fault streams of `injector` and raise the
    matching typed error. The engine calls this before a step touches the
    KV pools, so an injected fault never leaves a half-written step."""
    if injector.fire("kernel_compile", kernel=kernel, **ctx):
        _count("injected_faults")
        raise KernelCompileError("injected kernel compile failure",
                                 kernel=kernel)
    if injector.fire("kernel_oom", kernel=kernel, **ctx):
        _count("injected_faults")
        raise KernelResourceError("injected out-of-memory", kernel=kernel)
    if injector.fire("kernel_nan", kernel=kernel, **ctx):
        _count("injected_faults")
        raise KernelNumericsError("injected non-finite kernel output",
                                  kernel=kernel)
