"""Shape suites assigned to the LM family, plus input specs.

The reference package's ``configs/shapes.py``: the four shape suites, which
(arch x shape) cells are defined, and the inputs of the step function each
cell runs (``batch_specs`` for train and prefill, ``decode_batch_specs``
for one decode step). A spec is a ``Spec(shape, dtype)`` pair with a
``torch.dtype``; ``Spec.meta()`` makes a meta tensor of it. Nothing here
allocates device memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import token_split
from repro_torch.configs.base import ArchConfig

__all__ = ["ALL_SHAPE_NAMES", "SHAPES", "ShapeSuite", "Spec", "batch_specs",
           "cache_seq_len", "cell_supported", "decode_batch_specs",
           "token_split"]


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524_288, 1, "decode"),
}


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def cell_supported(arch: ArchConfig, shape: ShapeSuite) -> Tuple[bool, str]:
    """Whether this (arch x shape) cell is defined, and why not if skipped."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{arch.name} is pure full-attention (skip per spec, see DESIGN.md)"
        )
    return True, ""


def batch_specs(arch: ArchConfig, shape: ShapeSuite) -> Dict[str, Spec]:
    """Model inputs for a full forward over `seq_len` (train / prefill)."""
    b, s = shape.global_batch, shape.seq_len
    front, text = token_split(arch, s)
    specs: Dict[str, Spec] = {
        "tokens": Spec((b, text), torch.int32),
        "targets": Spec((b, text), torch.int32),
        "positions": Spec((b, text), torch.int32),
    }
    if arch.enc_dec:
        # stub conv frontend: precomputed frame embeddings
        specs["frames"] = Spec((b, front, arch.d_model), getattr(torch, arch.dtype))
    elif arch.vlm:
        # stub SigLIP frontend: precomputed patch embeddings
        specs["patches"] = Spec((b, front, arch.d_model), getattr(torch, arch.dtype))
    return specs


def decode_batch_specs(arch: ArchConfig, shape: ShapeSuite) -> Dict[str, Spec]:
    """Model inputs for one decode step (one new token per sequence)."""
    b = shape.global_batch
    return {
        "tokens": Spec((b, 1), torch.int32),
        "positions": Spec((b, 1), torch.int32),
    }


def cache_seq_len(arch: ArchConfig, shape: ShapeSuite) -> int:
    """Per-layer attention KV length held by the decode cache."""
    if arch.sliding_window:
        return min(arch.sliding_window, shape.seq_len)
    return shape.seq_len


ALL_SHAPE_NAMES = tuple(SHAPES)
