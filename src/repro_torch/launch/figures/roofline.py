"""Roofline table: reads the dry-run's records (``reports/dryrun/*.json``,
written by `repro_torch.launch.dryrun`), the reference package's
``benchmarks/roofline.py``.

Per (arch x shape x mesh): the three terms in seconds, the dominant
bottleneck, MODEL_FLOPS/traced FLOPs (useful-compute ratio), and bytes a
chip. With no records the table is its header alone.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.kernel_bench import csv_table

__all__ = ["DEFAULT_DIR", "load", "rows", "table"]

DEFAULT_DIR = Path("reports/dryrun")


def load(report_dir=DEFAULT_DIR):
    recs = []
    for p in sorted(Path(report_dir).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def rows(report_dir=DEFAULT_DIR):
    out = []
    for r in load(report_dir):
        if r.get("status") == "skipped":
            out.append([r["arch"], r["shape"], r["mesh"], "SKIP", "", "", "", "", "", ""])
            continue
        if r.get("status") != "ok":
            out.append([r["arch"], r["shape"], r["mesh"], "ERROR", "", "", "", "", "", ""])
            continue
        t = r["terms"]
        out.append([
            r["arch"], r["shape"], r["mesh"], r["dominant"].replace("_s", ""),
            f"{t['compute_s']:.3e}", f"{t['memory_s']:.3e}",
            f"{t['collective_s']:.3e}",
            round(r["useful_flops_ratio"], 3),
            round(r["memory"].get("argument_size_in_bytes", 0) / 2**30, 2),
            round(r["memory"].get("temp_size_in_bytes", 0) / 2**30, 2),
        ])
    return out


def table(report_dir=DEFAULT_DIR) -> str:
    return csv_table(
        ["arch", "shape", "mesh", "dominant", "compute_s", "memory_s",
         "collective_s", "useful_ratio", "args_GiB_dev", "temp_GiB_dev"],
        rows(report_dir))


if __name__ == "__main__":
    print(table())
