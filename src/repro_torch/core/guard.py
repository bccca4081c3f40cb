"""Guarded execution for the port's kernel substrate.

Every public kernel wrapper runs its kernel through `guarded_call`, which
gives a call a defined completion/failure contract: it returns an output
that passed its checks, or it raises a typed error. Kernel faults may cost
throughput, never answers. The pieces:

* **Error taxonomy** — `SubstrateError` (kernel name, machine profile,
  depth, tile shape) with four concrete classes: `KernelCompileError`
  (build / launch failures), `KernelResourceError` (out of device or shared
  memory), `KernelNumericsError` (non-finite outputs) and
  `KernelParityError` (kernel against its plain version). Two flags say
  what a retry may do: `refused` (the launch was refused before the kernel
  ran, so nothing was written) and `retriable` (False when no smaller depth
  can help: a failed build or load, which is the same source at every
  depth, or a lost CUDA context).
* **Depth ladder** — a failed attempt at depth d quarantines (machine,
  kernel, d) in `core.autotune` (so `choose_depth` never proposes it
  again) and is retried at ``max(1, d // 2)``; the caller's `attempt(d)`
  re-derives everything the depth decides. When depth 1 fails too, the
  last typed error is raised: there is no fallback, and the plain
  version's output is never returned. A kernel that writes in place
  (``in_place=True``) is retried only after a refused launch; nothing
  raised after the attempt returned counts as refused.
* **Always-on scan** — `scan_output` flags a non-finite floating tensor of
  every eager call's output (reading the verdict waits for the device); a
  caller may pass its own `finite` check instead (the in-place scatter-add
  reads the rows it wrote without copying them).
* **Parity sentinel** — opt-in (`REPRO_PARITY`: ``off`` | ``sampled`` |
  ``full``, `REPRO_PARITY_EVERY`): a deterministic 1-in-N sample of guarded
  calls also runs the plain version on the same tensors, before the
  attempt, and compares it with what the attempt wrote. A mismatch raises
  `KernelParityError` in strict mode, else quarantines the depth and walks
  the ladder, every rung checked again.
* **Strict mode** — `set_strict(True)` (``--strict`` on the launchers):
  the first failure raises, with no ladder.
* **Capture** — inside a CUDA graph capture a guarded call runs its attempt
  once: no scan, sentinel, injection or ladder (nothing can be read back
  while capturing). The eager step a `core.step_graph.StepGraph` runs before
  each capture is where the guard polices a graphed step.

Every backoff and parity mismatch emits an `obs` trace instant and a
``substrate.*`` counter; `stats()` reports plain-int totals that survive
``REPRO_TELEMETRY=0``. Inside `record()` each guarded call also hands back
its `GuardResult`: the launch it ran, as a thunk that runs it again without
the guard (for timing loops), and CUDA events around that attempt alone
(for transfer samples that must not include the checks).

Fault injection: `set_injector` installs a `serve.faults`-style injector
whose ``kernel_compile`` / ``kernel_oom`` streams fire before every guarded
attempt and whose ``kernel_nan`` stream poisons what an attempt wrote (a
copy: a kernel's real output is never overwritten), so the scan must catch
it. `check_injected` raises the same typed errors at engine call sites.
This module must not import `serve.faults` (serve imports kernels imports
this): the null injector is local.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

__all__ = [
    "GuardResult",
    "KernelCompileError",
    "KernelNumericsError",
    "KernelParityError",
    "KernelResourceError",
    "SubstrateError",
    "check_injected",
    "guarded_call",
    "last_ladder",
    "parity_mode",
    "record",
    "reset",
    "scan_output",
    "set_injector",
    "set_parity",
    "set_strict",
    "stats",
    "strict_mode",
]

PARITY_ENV = "REPRO_PARITY"            # off | sampled | full
PARITY_EVERY_ENV = "REPRO_PARITY_EVERY"
DEFAULT_PARITY_EVERY = 4               # sampled mode checks call 1, N+1, ...

# substrings that mark a raw failure as resource pressure, and those of the
# CUDA errors that leave the context unusable (sticky errors)
_RESOURCE_MARKERS = ("resource_exhausted", "resource exhausted",
                     "out of memory", "too many resources", "shared memory")
_STICKY_MARKERS = ("illegal memory access", "illegal address",
                   "unspecified launch failure", "device-side assert",
                   "misaligned address", "illegal instruction",
                   "hardware stack error", "invalid program counter",
                   "launch timed out")


# ---------------------------------------------------------------- taxonomy


class SubstrateError(RuntimeError):
    """A kernel-substrate failure with its launch context attached.

    `refused`: the launch was refused before the kernel ran (nothing was
    written). `retriable`: False when no smaller depth can help."""

    def __init__(self, message: str, *, kernel: str = "?",
                 machine: Optional[str] = None, depth: Optional[int] = None,
                 tile: Optional[Tuple[int, ...]] = None,
                 refused: bool = False, retriable: bool = True):
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
        self.refused = refused
        self.retriable = retriable


class KernelCompileError(SubstrateError):
    """Build, load or launch failure (or an injected stand-in)."""


class KernelResourceError(SubstrateError):
    """Out of device memory or shared memory at the attempted depth."""


class KernelNumericsError(SubstrateError):
    """Non-finite values in a kernel's output (the always-on scan)."""


class KernelParityError(SubstrateError):
    """A kernel's output diverged from its plain version."""


# ------------------------------------------------------------ module state


class _NullInjector:
    """Default injector: never fires (`serve.faults.NULL_INJECTOR` has the
    same surface, but importing it here would close an import cycle)."""

    __slots__ = ()

    def fire(self, site: str, **ctx: Any) -> bool:
        return False


_NULL_INJECTOR = _NullInjector()

_COUNT_KEYS = ("guarded_calls", "clean_calls", "backoffs", "parity_checks",
               "parity_mismatches", "numerics_faults", "injected_faults")

_lock = threading.RLock()
_strict: bool = False
_parity_mode: str = "off"
_parity_every: int = DEFAULT_PARITY_EVERY
_injector: Any = _NULL_INJECTOR
_counts: Dict[str, int] = {}
_parity_counter: Dict[Tuple[str, str], int] = {}
_last_ladder: Dict[Tuple[str, str], List[int]] = {}
_recording = threading.local()         # .calls: the list `record()` fills


def _key(kernel: str) -> Tuple[str, str]:
    from repro_torch.core.machine import get_machine
    return (get_machine().name, kernel)


def _env_parity() -> Tuple[str, int]:
    mode = os.environ.get(PARITY_ENV, "off").strip().lower()
    if mode not in ("off", "sampled", "full"):
        mode = "off"
    try:
        every = max(1, int(os.environ.get(PARITY_EVERY_ENV,
                                          DEFAULT_PARITY_EVERY)))
    except ValueError:
        every = DEFAULT_PARITY_EVERY
    return mode, every


def reset() -> None:
    """Strict off, the sentinel from the environment, no injector, zero
    counters (test isolation: `repro_torch.reset()`)."""
    global _strict, _parity_mode, _parity_every, _injector
    with _lock:
        _strict = False
        _parity_mode, _parity_every = _env_parity()
        _injector = _NULL_INJECTOR
        _counts.clear()
        _counts.update({k: 0 for k in _COUNT_KEYS})
        _parity_counter.clear()
        _last_ladder.clear()


reset()


def set_strict(on: bool) -> None:
    """Disable the ladder: the first failure raises its typed
    `SubstrateError` (``--strict``)."""
    global _strict
    _strict = bool(on)


def strict_mode() -> bool:
    return _strict


def set_parity(mode: str, every: Optional[int] = None) -> None:
    """Set the sentinel mode: ``off`` | ``sampled`` (1-in-`every`) |
    ``full`` (every eager guarded call)."""
    global _parity_mode, _parity_every
    if mode not in ("off", "sampled", "full"):
        raise ValueError(f"parity mode must be off|sampled|full, got {mode!r}")
    _parity_mode = mode
    if every is not None:
        _parity_every = max(1, int(every))


def parity_mode() -> str:
    return _parity_mode


def set_injector(injector: Optional[Any]) -> None:
    """Install a `serve.faults.FaultInjector` (or None to clear) whose
    kernel-site streams fire inside every eager guarded call."""
    global _injector
    _injector = injector if injector is not None else _NULL_INJECTOR


def last_ladder(kernel: str) -> List[int]:
    """Depths attempted by the most recent guarded call for `kernel` under
    the active machine (halving on failure)."""
    with _lock:
        return list(_last_ladder.get(_key(kernel), ()))


def stats() -> Dict[str, Any]:
    """Plain-int substrate totals (process-wide; survives
    ``REPRO_TELEMETRY=0``)."""
    with _lock:
        out: Dict[str, Any] = {k: _counts.get(k, 0) for k in _COUNT_KEYS}
    out["strict"] = _strict
    out["parity"] = _parity_mode
    return out


def _count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    from repro_torch.obs import metrics
    metrics.default_registry().counter(f"substrate.{name}").inc(n)


def _instant(name: str, **args: Any) -> None:
    from repro_torch.obs import trace
    trace.get_tracer().instant(name, tid=trace.TID_KERNEL, **args)


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
        if not _all_finite(t):
            return _nonfinite(kernel, depth)
    return None


def _all_finite(t: torch.Tensor) -> bool:
    """Whether every value of the floating tensor `t` is finite, in one
    read of it: its min and max (a NaN or an Inf anywhere reaches one of
    them), not a temporary the size of `t`."""
    if t.numel() == 0:
        return True
    lo, hi = torch.aminmax(t)
    return bool(torch.isfinite(torch.stack((lo, hi))).all())


def _tolerance(tensors: Sequence[torch.Tensor]) -> Tuple[float, float]:
    for t in tensors:
        if t.dtype in (torch.bfloat16, torch.float16):
            return 3e-2, 3e-2
    return 2e-3, 2e-3


def _parity_matches(out: Any, ref: Any) -> bool:
    a, b = list(_tensors(out)), list(_tensors(ref))
    if len(a) != len(b):
        return False
    rtol, atol = _tolerance(a)
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return False
        if x.is_floating_point() or y.is_floating_point():
            ok = torch.allclose(x.float(), y.float(), rtol=rtol, atol=atol)
        else:
            ok = torch.equal(x, y)
        if not ok:
            return False
    return True


# --------------------------------------------------------- fault injection


def check_injected(kernel: str, injector: Optional[Any] = None,
                   **ctx: Any) -> None:
    """Fire the kernel-site fault streams of `injector` (default: the one
    `set_injector` installed) and raise the matching typed error. The
    engine calls this before a step touches the KV pools, so an injected
    fault never leaves a half-written step."""
    inj = injector if injector is not None else _injector
    if inj.fire("kernel_compile", kernel=kernel, **ctx):
        _count("injected_faults")
        raise KernelCompileError("injected kernel compile failure",
                                 kernel=kernel, refused=True)
    if inj.fire("kernel_oom", kernel=kernel, **ctx):
        _count("injected_faults")
        raise KernelResourceError("injected out-of-memory", kernel=kernel,
                                  refused=True)
    if inj.fire("kernel_nan", kernel=kernel, **ctx):
        _count("injected_faults")
        raise KernelNumericsError("injected non-finite kernel output",
                                  kernel=kernel, refused=True)


def _inject_pre(kernel: str, depth: int) -> None:
    if _injector.fire("kernel_compile", kernel=kernel, depth=depth):
        _count("injected_faults")
        raise KernelCompileError("injected kernel compile failure",
                                 kernel=kernel, depth=depth, refused=True)
    if _injector.fire("kernel_oom", kernel=kernel, depth=depth):
        _count("injected_faults")
        raise KernelResourceError("injected out-of-memory", kernel=kernel,
                                  depth=depth, refused=True)


def _inject_poison(kernel: str) -> bool:
    """kernel_nan stream: True when this attempt's output is to be taken
    as poisoned, so that the always-on scan must catch it."""
    if not _injector.fire("kernel_nan", kernel=kernel):
        return False
    _count("injected_faults")
    return True


def _poisoned(view: Any) -> Any:
    """A copy of `view` whose first floating tensor is NaN (a kernel's
    real output is never overwritten)."""
    leaves = list(_tensors(view))
    for i, t in enumerate(leaves):
        if t.is_floating_point():
            leaves[i] = torch.full_like(t, float("nan"))
            return leaves
    return view


# ------------------------------------------------------------ guarded_call


@dataclasses.dataclass
class GuardResult:
    """What a guarded call produced and how it got there. `rerun()` runs
    the attempt that produced `out` again, at the same depth and without
    the guard (a kernel that writes in place writes again). `events` are
    CUDA events recorded just before and just after that attempt, inside
    `record()` on CUDA operands, else None."""

    out: Any
    depth: int
    path: str           # clean | backoff
    kernel: str = "?"
    rerun: Optional[Callable[[], Any]] = None
    events: Optional[Tuple[Any, Any]] = None

    def device_s(self) -> float:
        """Device seconds between the attempt's events (waits for the
        second); raises when none were recorded."""
        if self.events is None:
            raise ValueError(f"{self.kernel}: no events were recorded")
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end) / 1e3


@contextlib.contextmanager
def record():
    """Within: every guarded call of this thread appends its `GuardResult`
    to the list this yields, and an eager call on CUDA operands records
    CUDA events around the attempt it returns (`GuardResult.events`)."""
    outer = getattr(_recording, "calls", None)
    calls: List[GuardResult] = []
    _recording.calls = calls
    try:
        yield calls
    finally:
        _recording.calls = outer


def _classify(exc: Exception, kernel: str, depth: int,
              tile: Optional[Tuple[int, ...]], *,
              launched: bool = False) -> SubstrateError:
    """A raw exception as a typed one (the original as ``__cause__``):
    device out-of-memory raised by an attempt is a refused launch (an
    attempt allocates before it launches), but raised once the attempt
    returned (`launched`: by the checks of what it wrote) it is not; a
    sticky CUDA error is not retriable, other resource pressure is
    `KernelResourceError`, anything else `KernelCompileError`."""
    if isinstance(exc, SubstrateError):
        return exc
    msg = f"{type(exc).__name__}: {exc}"
    low = msg.lower()
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        err = KernelResourceError(msg, kernel=kernel, depth=depth, tile=tile,
                                  refused=not launched)
    elif any(marker in low for marker in _STICKY_MARKERS):
        err = KernelCompileError(msg, kernel=kernel, depth=depth, tile=tile,
                                 retriable=False)
    elif any(marker in low for marker in _RESOURCE_MARKERS):
        err = KernelResourceError(msg, kernel=kernel, depth=depth, tile=tile)
    else:
        err = KernelCompileError(msg, kernel=kernel, depth=depth, tile=tile)
    err.__cause__ = exc
    return err


def _spec_tile(spec: Any) -> Optional[Tuple[int, ...]]:
    streams = (*getattr(spec, "loads", ()), *getattr(spec, "stores", ()))
    return tuple(streams[0].tile) if streams else None


def _capturing(operands: Sequence[Any]) -> bool:
    """True while the current CUDA stream is capturing a graph (only asked
    when an operand lies on the card: a CPU build has no CUDA runtime)."""
    return any(t.is_cuda for t in _tensors(list(operands))) \
        and torch.cuda.is_current_stream_capturing()


def _parity_reference(kernel: str, operands: Sequence[Any],
                      plain: Callable[..., Any]) -> Optional[Any]:
    """The plain version's answer when this call is sampled, else None.
    Sampled mode checks call 1, N+1, 2N+1, ... per (machine, kernel). It
    runs before the attempt, so that a kernel that writes in place is
    compared with what its operands held before it ran."""
    if _parity_mode == "off":
        return None
    key = _key(kernel)
    with _lock:
        n = _parity_counter.get(key, 0) + 1
        _parity_counter[key] = n
    if _parity_mode == "sampled" and (n - 1) % _parity_every:
        return None
    # the sentinel is no op of the program: it runs hidden from dispatch
    # modes (a selective checkpoint matches a layer's recomputed ops to its
    # forward's by their order, and sampling differs between the two)
    with _disable_current_modes():
        return plain(*operands)


def _nonfinite(kernel: str, depth: int) -> KernelNumericsError:
    _count("numerics_faults")
    _instant("substrate_nonfinite", kernel=kernel, depth=depth)
    return KernelNumericsError("non-finite values in kernel output",
                               kernel=kernel, depth=depth)


def _police(kernel: str, out: Any, depth: int,
            tile: Optional[Tuple[int, ...]], ref: Optional[Any],
            written: Optional[Callable[[Any], Any]],
            finite: Optional[Callable[[Any], Any]]
            ) -> Optional[SubstrateError]:
    """The checks of a finished attempt: injected poison, the scan (of
    `written(out)`, or `finite(out)` when given), the sentinel. Returns the
    failure, or None."""
    poison = _inject_poison(kernel)
    view = None
    if finite is None or ref is not None:
        view = out if written is None else written(out)
        if poison:
            view = _poisoned(view)
    if finite is None:
        nerr = scan_output(kernel, view, depth=depth)
        if nerr is not None:
            return nerr
    elif poison or not bool(finite(out)):
        return _nonfinite(kernel, depth)
    if ref is None:
        return None
    _count("parity_checks")
    with _disable_current_modes():
        same = _parity_matches(view, ref)
    if same:
        return None
    _count("parity_mismatches")
    _instant("parity_mismatch", kernel=kernel, depth=depth)
    return KernelParityError("kernel output diverged from its plain version",
                             kernel=kernel, depth=depth, tile=tile)


def guarded_call(spec: Any, operands: Sequence[Any],
                 attempt: Callable[[int], Any], *, depth: int, n_tiles: int,
                 plain: Callable[..., Any], in_place: bool = False,
                 written: Optional[Callable[[Any], Any]] = None,
                 finite: Optional[Callable[[Any], Any]] = None
                 ) -> GuardResult:
    """Run `attempt(depth)` under the substrate guard (module docstring).

    `attempt(d)` runs the call at depth d: the kernel, re-deriving what the
    depth decides, for CUDA tensors; the plain version for CPU tensors.
    `plain(*operands)` is the sentinel's reference for `written(out)` (the
    whole output when `written` is None), computed before the attempt.
    The scan reads `written(out)` too, unless `finite(out)` is given: a
    0-d bool tensor, whether everything the attempt wrote is finite.
    A kernel with ``in_place=True`` updates an operand: only a refused
    launch is retried, and `written` should select what it wrote. Raises
    the last typed `SubstrateError` when the ladder is exhausted, at once
    in strict mode, for a failure no smaller depth can help, and, in place,
    for a failure after the launch.
    """
    kernel = spec.name
    d = min(int(depth), n_tiles) if n_tiles > 0 else int(depth)
    _count("guarded_calls")
    calls = getattr(_recording, "calls", None)
    if _capturing(operands):
        out = attempt(d)
        _count("clean_calls")
        return _result(calls, out, d, "clean", kernel, attempt, None)

    key = _key(kernel)
    tile = _spec_tile(spec)
    ref = _parity_reference(kernel, operands, plain)
    timed = calls is not None and any(
        t.is_cuda for t in _tensors(list(operands)))
    ladder: List[int] = []
    while True:
        ladder.append(d)
        events = None
        try:
            _inject_pre(kernel, d)
            if timed:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            out = attempt(d)
            if timed:
                events[1].record()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:  # noqa: BLE001 - classified below
            err = _classify(exc, kernel, d, tile)
        else:
            try:
                err = _police(kernel, out, d, tile, ref, written, finite)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc:  # noqa: BLE001 - e.g. a sticky error
                err = _classify(exc, kernel, d, tile, launched=True)

        if err is None:
            with _lock:
                _last_ladder[key] = ladder
            if len(ladder) == 1:
                _count("clean_calls")
                return _result(calls, out, d, "clean", kernel, attempt,
                               events)
            return _result(calls, out, d, "backoff", kernel, attempt, events)

        _quarantine(kernel, d)
        if _strict or d <= 1 or not err.retriable \
                or (in_place and not err.refused):
            with _lock:
                _last_ladder[key] = ladder
            raise err
        nxt = max(1, d // 2)
        _count("backoffs")
        _instant("substrate_backoff", kernel=kernel, from_depth=d,
                 to_depth=nxt, error=type(err).__name__)
        d = nxt


def _result(calls: Optional[List[GuardResult]], out: Any, depth: int,
            path: str, kernel: str, attempt: Callable[[int], Any],
            events: Optional[Tuple[Any, Any]]) -> GuardResult:
    res = GuardResult(out=out, depth=depth, path=path, kernel=kernel,
                      rerun=functools.partial(attempt, depth), events=events)
    if calls is not None:
        calls.append(res)
    return res


def _quarantine(kernel: str, depth: int) -> None:
    from repro_torch.core import autotune
    autotune.quarantine_config(kernel, depth)
