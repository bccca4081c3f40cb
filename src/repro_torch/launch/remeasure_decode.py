"""Re-measure the decode and long-context cells on the single mesh (the
reference package's ``scripts/remeasure_decode.py``). The reference
compiled them again fully unrolled; a trace is the full depth already, so
here ``full_unroll`` gives the same records, written to ``reports/dryrun``
(``--out``).

  PYTHONPATH=src python -m repro_torch.launch.remeasure_decode
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import ALL_ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, cell_supported
from repro_torch.launch.dryrun import run_cell

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)
    for arch in ALL_ARCH_NAMES:
        for shape in ("decode_32k", "long_500k"):
            if not cell_supported(get_config(arch), SHAPES[shape])[0]:
                continue
            try:
                rec = run_cell(arch, shape, "single", out_dir=args.out,
                               verbose=False, full_unroll=True)
                print(arch, shape, "ok", f"{rec['hlo_flops_per_chip']:.3e}",
                      rec["dominant"], flush=True)
            except Exception as e:  # keep sweeping
                print(arch, shape, "ERROR", repr(e), flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
