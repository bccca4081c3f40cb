"""The port's hand-written GPU kernels.

Each kernel module keeps, beside its CUDA wrapper, the plain PyTorch version
of the same function and a launch counter on the wrapper. `KERNELS` names
every wrapper so a run can read and reset the counts.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.kernels.decode_attention.decode_attention import (
    paged_flash_decode,
)

KERNELS: Dict[str, Callable] = {"paged_decode": paged_flash_decode}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
