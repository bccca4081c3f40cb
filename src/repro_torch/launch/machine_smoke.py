"""Print the machine-profile smoke record (the reference's
``scripts/machine_smoke.py``): the active profile, its HBM latency, the
solved row-gather depth and the depth one launched gather ran, as one JSON
line (`launch.gups.machine_smoke`; the same as ``launch.gups --smoke``).

  PYTHONPATH=src python -m repro_torch.launch.machine_smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.gups import machine_smoke


def main(argv=None):
    from repro_torch.serve.engine import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rec = machine_smoke(resolve_device(args.device))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
