"""Parameter declaration: shapes + logical axes + initializers in one tree.

Models declare a nested dict of ``ParamSpec``; `initialize` materializes it
as tensors on a device from a seeded `torch.Generator`, and
`params_from_numpy` takes the reference package's parameters (its pytree
with numpy leaves) across with the same names and shapes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["ParamSpec", "count", "initialize", "is_spec", "map_specs",
           "params_from_numpy", "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "float32"
    init: str = "normal"  # normal | zeros | ones | fan_in
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch.dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def map_specs(fn: Callable[[ParamSpec], Any], tree):
    """Apply `fn` to every spec of a nested dict, keeping its structure."""
    if is_spec(tree):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    if is_spec(tree):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, f"{prefix}.{k}" if prefix else k)


def count(tree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(tree))


def _fan_in_scale(s: ParamSpec) -> float:
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    return 1.0 / float(np.sqrt(max(fan_in, 1)))


def initialize(spec_tree, generator: torch.Generator, device) -> Dict[str, Any]:
    """Materialize real parameter tensors on `device`, one leaf at a time.

    normal / fan_in leaves are drawn in f32 from `generator` (which must
    live on `device`) and cast to the spec's dtype; a stacked ``[L, ...]``
    leaf is drawn one layer slice at a time, so the transient f32 copy is
    one layer, not the whole stack. The numbers differ from the reference
    package's (a torch generator is not a jax key); tests that compare the
    two packages bridge the reference's parameters with `params_from_numpy`.
    """
    device = torch.device(device)

    def make(s: ParamSpec) -> torch.Tensor:
        dt = torch_dtype(s.dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        scale = _fan_in_scale(s) if s.init == "fan_in" else s.scale
        out = torch.empty(s.shape, dtype=dt, device=device)
        slices = out if len(s.shape) >= 3 else out[None]
        for part in slices:
            draw = torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device)
            part.copy_(draw.mul_(scale))
        return out

    return map_specs(make, spec_tree)


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16; widen exactly
        a = a.astype(np.float32)
    # a copy: the reference's arrays are read-only views
    return torch.from_numpy(np.array(a, copy=True)).to(device=device,
                                                       dtype=dtype)


def params_from_numpy(tree, cfg, device) -> Dict[str, Any]:
    """The reference package's parameters -> the port's.

    `tree` is the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, model.init(key))``). Returns a nested dict
    of tensors on `device` with the same names and shapes, each cast to the
    port's declared dtype for `cfg`; a missing, extra or misshapen leaf
    raises ValueError."""
    from repro_torch.models.lm import param_specs

    specs = param_specs(cfg)
    seen = set()

    def take(path: Tuple[str, ...], s: ParamSpec) -> torch.Tensor:
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                raise ValueError(f"reference params lack {'.'.join(path)}")
            node = node[k]
        a = np.asarray(node)
        if tuple(a.shape) != tuple(s.shape):
            raise ValueError(f"{'.'.join(path)}: shape {a.shape} != "
                             f"{s.shape}")
        seen.add(path)
        return _to_tensor(a, torch_dtype(s.dtype), device)

    def walk(spec, path):
        if is_spec(spec):
            return take(path, spec)
        return {k: walk(v, path + (k,)) for k, v in spec.items()}

    out = walk(specs, ())
    extra = {p for p, _ in _numpy_leaves(tree)} - seen
    if extra:
        raise ValueError(f"reference params have leaves the port does not "
                         f"declare: {sorted('.'.join(p) for p in extra)}")
    return out


def _numpy_leaves(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numpy_leaves(v, prefix + (k,))
    else:
        yield prefix, tree
