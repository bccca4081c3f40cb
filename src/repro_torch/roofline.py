"""Roofline accounting: analytic model FLOPs, the traced step's counts, and
the machine terms (the reference package's ``roofline.py``).

The hardware model is the active `core.machine` profile (one
`MachineModel` definition shared with the depth solver; the port's default
is ``h100``, dialed with ``REPRO_MACHINE``). The names `PEAK_FLOPS`,
`HBM_BW` and `ICI_BW` resolve to the active profile via module
`__getattr__`.

The three terms, per (arch x shape x mesh), all **per chip** (rank 0's
program is the per-chip program, as the reference's SPMD module is):

  compute    = traced FLOPs / peak_flops
  memory     = traced bytes / hbm_bw
  collective = collective bytes / ici_bw

`model_flops`, `terms` and `dominant` are the reference's, line for line.
The reference reads its counts from XLA's compiled module; the port has
none, so it counts a trace of the rank's own step instead: `StepCounter`,
a `TorchDispatchMode` over meta tensors (no memory, no device), which
records every aten op the step dispatches, forward and backward:

  * FLOPs: of the ops that `torch.utils.flop_counter` has a formula for
    (mm, addmm, bmm, baddbmm, the convolutions, the SDPA ops; elementwise
    ops count none), and of each hand-written kernel its own cost function
    (the kernels' meta route, `kernels.ring.meta_call`);
  * bytes: the inputs plus the new outputs of every op that materializes
    memory (views and other aliases of an input count nothing, an in-place
    op's mutated operand counts once, an ``empty`` counts nothing) and each
    kernel's cost bytes. The eager port fuses nothing, so this is the
    traffic it moves, op by op;
  * memory: the arguments' bytes (the distinct storages the rank holds
    going in that the step reads: an argument it never reads is not part
    of its program, as XLA drops an unused parameter of a jitted
    function), the outputs' bytes, and ``temp``: the peak, over the step,
    of the live bytes of the storages the step made that are not outputs,
    counted by storage (a view adds nothing);
  * collectives: the operand bytes of the mesh's collectives by kind
    (`sharding.collective_stats()["by_kind"]`), as a running mesh counts
    them (a dry mesh runs the same code without the communication).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry as _FLOP_FORMULAS

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSuite, cache_seq_len, token_split
from repro_torch.core.machine import MachineModel, get_machine

__all__ = ["StepCounter", "collective_bytes", "dominant", "hbm_bytes",
           "kernel_call", "model_flops", "terms"]

# --------------------------------------------------------- analytic FLOPs


def _flops_params(cfg: ArchConfig) -> int:
    """Matmul-active parameters (embedding lookup excluded, unembed included)."""
    n = cfg.n_active_params()
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model  # lookup table does no matmul flops
    return n


def model_flops(cfg: ArchConfig, shape: ShapeSuite, kind: str) -> float:
    """Analytic 'useful' FLOPs per step, whole job (divide by chips for/chip).

    train: 6*N*D + attention (causal 12*B*S^2*H*hd per... see DESIGN);
    MoE uses N_active. Attention/SSM mixer terms included since they dominate
    the 32k/500k shapes.
    """
    b = shape.global_batch
    front, text = token_split(cfg, shape.seq_len)
    hd = cfg.resolved_head_dim
    h = cfg.n_heads
    L = cfg.n_layers

    if kind == "train":
        tokens = b * (text + front)
        mult = 6.0
    elif kind == "prefill":
        tokens = b * (text + front)
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = b
        mult = 2.0

    flops = mult * _flops_params(cfg) * tokens

    # mixer terms
    if kind in ("train", "prefill"):
        s = text + (front if not cfg.enc_dec else 0)
        eff = min(cfg.sliding_window, s) if cfg.sliding_window else s
        if cfg.has_attention:
            # fwd = 4*B*S*eff*H*hd (qk+pv), /2 causal; train multiplies by 3
            a = 2.0 * b * s * eff * h * hd * L
            if cfg.enc_dec:
                a = 2.0 * b * front * front * h * hd * cfg.n_enc_layers \
                    + 2.0 * b * text * text * h * hd * L \
                    + 4.0 * b * text * front * h * hd * L  # cross (not causal)
            flops += a * (3.0 if kind == "train" else 1.0)
        if cfg.ssm or cfg.hybrid:
            q = cfg.ssm_chunk
            n = cfg.ssm_state
            nh, p = cfg.ssm_heads, cfg.ssm_head_dim
            ssd = 2.0 * b * s * (q * n + q * nh * p + 2.0 * n * nh * p) * L
            flops += ssd * (3.0 if kind == "train" else 1.0)
    else:
        if cfg.has_attention:
            s_kv = cache_seq_len(cfg, shape)
            flops += 4.0 * b * s_kv * h * hd * L
            if cfg.enc_dec:
                flops += 4.0 * b * shape.seq_len * h * hd * L  # cross over enc
        if cfg.ssm or cfg.hybrid:
            flops += 4.0 * b * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * L

    return flops


# ---------------------------------------------------------------- terms


def terms(per_chip_flops: float, per_chip_bytes: float,
          coll_bytes: Dict[str, int],
          *, machine: Optional[MachineModel] = None) -> Dict[str, float]:
    """Roofline terms under `machine` (default: the active profile — the
    SAME model `core.schedule.solve_depth` hides latency against)."""
    m = machine or get_machine()
    total_coll = float(sum(coll_bytes.values()))
    return {
        "compute_s": per_chip_flops / m.peak_flops,
        "memory_s": per_chip_bytes / m.hbm_bw,
        "collective_s": total_coll / m.ici_bw if m.ici_bw else 0.0,
    }


def dominant(t: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"), key=lambda k: t[k])


_LEGACY = {"PEAK_FLOPS": "peak_flops", "HBM_BW": "hbm_bw", "ICI_BW": "ici_bw"}


def __getattr__(name: str):
    # PEAK_FLOPS / HBM_BW / ICI_BW read the active machine profile — the
    # single definition is core.machine
    if name in _LEGACY:
        return getattr(get_machine(), _LEGACY[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ----------------------------------------------------- the traced step


_OPEN: list = []          # the StepCounters open in this process, innermost last


def _tensors(x, out: list) -> list:
    """The tensors in `x` (nested tuples, lists and dicts), in order: the
    ops' arguments and results hold nothing else that holds tensors."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (tuple, list, dict)):
                _tensors(v, out)
    elif isinstance(x, dict):
        _tensors(tuple(x.values()), out)
    return out


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _tensor_bytes(t: torch.Tensor) -> int:
    """What an op reads of `t`: its elements, at most its storage (a
    stride-0 expansion reads its few elements once)."""
    return min(t.numel() * t.element_size(), _storage(t).nbytes())


_OP_INFO: Dict[Any, tuple] = {}

# The outputs' (shape, stride, dtype) of a functional aten op on meta
# tensors, by the op and its arguments' metadata: a layer stack repeats the
# same ops on the same shapes, and a meta kernel (Python, for most ops)
# costs far more than making its empty outputs. An op whose output turns
# out to alias an input is never memoized (`_ALIASING`).
_MEMO: Dict[tuple, Any] = {}
_ALIASING: set = set()
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _meta_key(x):
    """A hashable description of an argument as a meta kernel sees it, or
    None where it cannot be memoized."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            return None
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, _PLAIN):
        return (type(x), x)
    if isinstance(x, (tuple, list)):
        keys = tuple(_meta_key(v) for v in x)
        return None if None in keys else keys
    return None


def _run(func, args, kwargs):
    """`func(*args, **kwargs)`, or its memoized empty meta outputs."""
    info = _OP_INFO.get(func)
    if info is None:
        info = _OP_INFO[func] = _op_info(func)
    _, _, writes, views = info
    if writes or views or func in _ALIASING:
        return func(*args, **kwargs)
    key = _meta_key((args, tuple(sorted(kwargs.items()))))
    if key is None:
        return func(*args, **kwargs)
    key = (func, key)
    shapes = _MEMO.get(key)
    if shapes is not None:
        outs = [torch.empty_strided(size, stride, dtype=dtype,
                                    device="meta")
                for size, stride, dtype in shapes[1]]
        return outs[0] if shapes[0] else shapes[2](outs)
    out = func(*args, **kwargs)
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else out
    if not isinstance(outs, (tuple, list)) or not outs or not all(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            for t in outs):
        return out
    ins = {id(t.untyped_storage()) for t in _tensors((args, kwargs), [])}
    if any(id(t.untyped_storage()) in ins for t in outs):
        _ALIASING.add(func)
        return out
    _MEMO[key] = (single, [(tuple(t.shape), t.stride(), t.dtype)
                           for t in outs], type(out))
    return out


def _op_info(func) -> tuple:
    """(its FLOP formula or None, whether it moves bytes (an ``empty``
    allocates and writes nothing), whether it writes into one of its
    arguments (in place or out=), whether an output may alias an input)
    of an aten op."""
    packet = func._overloadpacket
    schema = func._schema
    writes = any(a.alias_info is not None and a.alias_info.is_write
                 for a in schema.arguments)
    views = any(r.alias_info is not None for r in schema.returns)
    return (_FLOP_FORMULAS.get(packet),
            not packet.__name__.startswith(("empty", "new_empty")), writes,
            views)


class StepCounter(TorchDispatchMode):
    """Counts one step's FLOPs, bytes, memory and collectives on meta
    tensors (the module docstring says what each count holds). Open it
    around the step with the step's argument tensors::

        with StepCounter(args) as sc:
            out = step(*args)
        sc.finish(out)

    then read `flops`, `bytes`, `memory` (``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``temp_size_in_bytes``), `unread_bytes`
    (the arguments the step never read), `collectives`
    (operand bytes by kind), `collective_calls`, `kernels` (name ->
    calls, flops, bytes)."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: Dict[str, int] = {}
        self.collective_calls: Dict[str, int] = {}
        self.memory: Dict[str, int] = {}
        self._paused = 0
        self._held: Dict[int, Any] = {}        # argument storages, kept alive
        self._read: set = set()                # ... that an op or kernel read
        self._born: Dict[int, int] = {}        # live storages the step made
        self._events: list = []                # (key, +-bytes) in order
        self._serial = 0
        self._keys: Dict[int, int] = {}        # id(storage) -> key
        for t in _tensors(args, []):
            st = _storage(t)
            self._held.setdefault(id(st), st)

    # -------------------------------------------------------- bookkeeping
    def __enter__(self):
        from repro_torch import sharding

        self._coll0 = sharding.collective_stats()["by_kind"]
        _OPEN.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch import sharding

        _OPEN.remove(self)
        by_kind = sharding.collective_stats()["by_kind"]
        for kind, now in by_kind.items():
            before = self._coll0.get(kind, {"calls": 0, "bytes": 0})
            if now["calls"] > before["calls"]:
                self.collectives[kind] = now["bytes"] - before["bytes"]
                self.collective_calls[kind] = now["calls"] - before["calls"]
        return super().__exit__(*exc)

    def _track(self, outs) -> list:
        """Register the storages of the tensors `outs` that nothing held
        before; returns the tensors that hold them."""
        new = []
        for t in outs:
            st = t.untyped_storage()
            sid = id(st)
            if sid in self._held or sid in self._keys:
                continue
            self._serial += 1
            key = self._serial
            nbytes = st.nbytes()
            self._keys[sid] = key
            self._born[key] = nbytes
            self._events.append((key, nbytes))
            weakref.finalize(st, self._free, sid, key)
            new.append(t)
        return new

    def _free(self, sid: int, key: int) -> None:
        if self._keys.get(sid) == key:
            del self._keys[sid]
        nbytes = self._born.pop(key, None)
        if nbytes is not None:
            self._events.append((key, -nbytes))

    def read(self, t: torch.Tensor) -> bool:
        """Whether the step read the argument tensor `t`."""
        return id(_storage(t)) in self._read

    def mark_read(self, tensors) -> None:
        held = self._held
        for t in tensors:
            sid = id(t.untyped_storage())
            if sid in held:
                self._read.add(sid)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    @contextlib.contextmanager
    def paused(self):
        """Ops inside are tracked for memory but count no FLOPs or bytes
        (a kernel's meta outputs: its cost counts them)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _run(func, args, kwargs)
        fresh = self._track(_tensors(out, []))
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs, ins)
        self.mark_read(ins)
        if self._paused:
            return out
        formula, traffic, writes, _ = _OP_INFO[func]
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not traffic or not (fresh or writes):
            return out          # an empty, or a view or another alias
        self.bytes += sum(_tensor_bytes(t) for t in
                          {id(t): t for t in ins}.values()) \
            + sum(t.numel() * t.element_size() for t in fresh)
        return out

    # ------------------------------------------------------------- result
    def finish(self, out) -> Dict[str, int]:
        """Close the memory count on the step's outputs `out`: their
        distinct storages' bytes, and the peak of the live bytes of the
        storages the step made that are not outputs (`temp`)."""
        outs: Dict[int, int] = {}
        out_keys = set()
        for t in _tensors(out, []):
            st = _storage(t)
            outs[id(st)] = st.nbytes()
            if id(st) in self._keys:
                out_keys.add(self._keys[id(st)])
        live = peak = 0
        for key, delta in self._events:
            if key in out_keys:
                continue
            live += delta
            peak = max(peak, live)
        self.unread_bytes = int(sum(st.nbytes() for sid, st in
                                    self._held.items()
                                    if sid not in self._read))
        self.memory = {"argument_size_in_bytes": int(sum(
            self._held[sid].nbytes() for sid in self._read)),
                       "output_size_in_bytes": int(sum(outs.values())),
                       "temp_size_in_bytes": int(peak)}
        return self.memory


@contextlib.contextmanager
def kernel_call(name: str, flops: float, nbytes: float, operands=()):
    """One call of the hand-written kernel `name` on meta tensors
    `operands`: its (flops, bytes) recorded in the innermost open
    `StepCounter` (its operands read), whose op counts pause while the
    body makes the kernel's meta outputs (their memory is still
    tracked)."""
    if not _OPEN:
        yield
        return
    sc = _OPEN[-1]
    sc.mark_read(_tensors(operands, []))
    sc.add_kernel(name, flops, nbytes)
    with sc.paused():
        yield


def collective_bytes(trace: StepCounter) -> Dict[str, int]:
    """Operand bytes of every collective of the traced step, by kind
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``):
    the reference reads them from its HLO text; here the step's own
    collectives counted them (`sharding.collective_stats()["by_kind"]`).
    The port's reduce-scatters are all_to_alls and a sum, so they count
    as ``all-to-all``."""
    return dict(trace.collectives)


def hbm_bytes(trace: StepCounter) -> float:
    """The traced step's HBM traffic: every op's inputs and new outputs
    and every kernel's cost bytes (`StepCounter`). The reference models
    the TPU's fusions from its HLO; the eager port fuses nothing, so each
    op's traffic goes to HBM, and this is the same count as the trace's
    bytes."""
    return float(trace.bytes)
