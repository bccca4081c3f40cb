"""A compiled step replayed as one CUDA graph: the port's counterpart of
what `jax.jit` does for the reference's three compiled serving steps
(``runtime/steps.py:jit_decode_step``, the paged engine's ``_decode_fn``
and ``serve/prefill.py:ChunkedPrefiller``'s chunk step, one per padded
length and table width) and for its jitted, donated train step
(``runtime/steps.py:jit_train_step``: forward, backward and AdamW, the
state updated in place).

A `StepGraph` wraps a step function ``fn(*closed, *inputs)``. `closed` is
what the step closes over and never copies (parameters, KV caches and
pools, a train state, updated in place); `inputs` are the step's per-call
tensors (tokens, positions, block tables, lengths, a chunk's start and
length, a training batch), copied into static device buffers before
every replay (host tensors through pinned buffers). On CUDA tensors the
first call at a key runs the step once eagerly, on those buffers and on
the stream the capture uses: a real step, returned as such, which also
loads every CUDA module and solves every depth outside the capture (one
real step is the only warm-up, for the train step's backward too). Then
it captures the step with `torch.cuda.graph`, which empties the
allocator's cache as it begins: the blocks the eager step freed go back
to the device before the capture fills the graph's private pool, so a
step whose eager peak nearly fills the card (hymba-1.5b's train step) is
not held twice. Every later call at the same key replays the graph. The
key is the inputs' shapes and types and the addresses, shapes and types
of every closed tensor: another cache or pool is a new capture, never a
replay over stale addresses. One graph is kept per `StepGraph`; a new key
drops the old one, as a jitted function keeps one compiled step per input
signature. A caller that needs several live graphs (the chunked prefill:
one per padded length and table width) holds several `StepGraph`s.

What a replay returns is the graph's own output tensors, rewritten by the
next replay: a caller reads them before it calls again.

Launch counts stay true: the kernel launches a capture records are taken
back from each wrapper's count (nothing ran), and each replay adds them,
so `repro_torch.kernels.launch_counts()` counts kernels that ran on the
card. `stats()` gives the captures, capture seconds and replays of the
process in total and by each `StepGraph`'s name, so the decode graphs and
the prefill graphs can be told apart. On CPU tensors a call is the step
itself, run eagerly (the device rule). There is no switch that turns the
graphs off on the card: a capture or a replay that fails raises.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Iterator, Sequence, Tuple

import torch

__all__ = ["StepGraph", "reset", "stats"]

_STATS: Dict[str, Dict[str, Any]] = {}      # by StepGraph name
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _tally(name: str, **add) -> None:
    counts = _STATS.setdefault(name, {"captures": 0, "capture_s": 0.0,
                                      "replays": 0})
    for field, n in add.items():
        counts[field] += n


def stats() -> Dict[str, Any]:
    """Captures, seconds spent capturing and replays of every `StepGraph`
    of the process since the last `reset`: in total, and by name under
    ``by_name``."""
    by_name = {name: dict(c) for name, c in _STATS.items()}
    total = {field: sum((c[field] for c in by_name.values()), zero)
             for field, zero in (("captures", 0), ("capture_s", 0.0),
                                 ("replays", 0))}
    return {**total, "by_name": by_name}


def reset() -> None:
    _STATS.clear()


def _leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


class _Frozen:
    """`gc.freeze()` for the length of a with-block, thawed on the way out
    whether or not the block raised. Python thaws all frozen objects at
    once or none, and CPython 3.12 starts with objects frozen of its own,
    so a count cannot tell a caller's freeze apart: the block thaws
    everything, lest dead cycles frozen with it be kept for good."""

    def __enter__(self):
        gc.freeze()

    def __exit__(self, *exc):
        gc.unfreeze()


def _stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream the eager step and the capture of `device` run on."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


class StepGraph:
    """One step function, captured once per key and replayed (module
    docstring). `captures` and `replays` count this instance's; `stats()`
    adds them up under `name`."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.key = None
        self.graph = None
        self.out = None                  # the graph's outputs
        self.static: Tuple[torch.Tensor, ...] = ()   # its input buffers
        self.staging: Tuple[Any, ...] = ()           # pinned, for host inputs
        self.staged = None               # event: the last host copy is done
        self.launches: Dict[str, int] = {}           # per replay, by kernel
        self.captures = 0
        self.replays = 0

    def __call__(self, closed: Sequence, inputs: Sequence[torch.Tensor]):
        leaves = list(_leaves(closed))
        device = leaves[0].device
        if device.type != "cuda":
            return self.fn(*closed, *(x.to(device) for x in inputs))
        key = (tuple((tuple(x.shape), x.dtype) for x in inputs),
               tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in leaves))
        if key != self.key:
            return self._capture(key, device, closed, inputs)
        self._load(inputs)
        self.graph.replay()
        self._count(+1)
        self.replays += 1
        _tally(self.name, replays=1)
        return self.out

    def _count(self, sign: int) -> None:
        from repro_torch.kernels import KERNELS

        for name, n in self.launches.items():
            KERNELS[name].launches += sign * n

    def _load(self, inputs: Sequence[torch.Tensor]) -> None:
        """Copy the caller's inputs into the static buffers, on the current
        stream; a host tensor goes through its pinned buffer, which is
        rewritten only once the previous copy out of it has completed."""
        if self.staged is not None:
            self.staged.synchronize()
        for dst, pinned, x in zip(self.static, self.staging, inputs):
            if pinned is None:
                dst.copy_(x)
            else:
                pinned.copy_(x)
                dst.copy_(pinned, non_blocking=True)
        if any(p is not None for p in self.staging):
            self.staged = torch.cuda.Event()
            self.staged.record()

    def _capture(self, key, device: torch.device, closed: Sequence,
                 inputs: Sequence[torch.Tensor]):
        from repro_torch.kernels import launch_counts

        self.key = self.graph = self.out = self.staged = None
        self.launches = {}
        self.static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device)
                            for x in inputs)
        self.staging = tuple(
            torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            if x.device.type == "cpu" else None for x in inputs)
        self._load(inputs)
        stream = _stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            result = self.fn(*closed, *self.static)   # the real step
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # Nothing alive now is collected inside the capture: a dead
        # earlier graph in a reference cycle (an engine and its steps)
        # would be destroyed mid-capture, which CUDA refuses, breaking the
        # capture; torch.cuda.graph no longer collects before it begins.
        with _Frozen(), torch.cuda.graph(graph, stream=stream):
            out = self.fn(*closed, *self.static)
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self._count(-1)                  # a capture runs nothing
        self.graph, self.out, self.key = graph, out, key
        self.captures += 1
        _tally(self.name, captures=1, capture_s=time.perf_counter() - t0)
        return result
