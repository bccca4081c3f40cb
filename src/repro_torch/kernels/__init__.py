"""The port's hand-written GPU kernels.

Each kernel module keeps, beside its CUDA wrapper, the plain PyTorch version
of the same function and a launch counter on the wrapper. `KERNELS` names
every wrapper so a run can read and reset the counts.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.kernels.coro_gather.coro_gather import row_gather, span_gather
from repro_torch.kernels.coro_scatter_add.coro_scatter_add import (
    scatter_add_unique,
)
from repro_torch.kernels.decode_attention.decode_attention import (
    flash_decode,
    paged_flash_decode,
)
from repro_torch.kernels.moe_gmm.moe_gmm import gmm
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.kernels.stream_copy.stream_copy import triad

KERNELS: Dict[str, Callable] = {
    "paged_decode": paged_flash_decode,
    "moe_gmm": gmm,
    "flash_decode": flash_decode,
    "ssd_scan": ssd_scan,
    "row_gather": row_gather,
    "span_gather": span_gather,
    "scatter_add": scatter_add_unique,
    "stream_triad": triad,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
