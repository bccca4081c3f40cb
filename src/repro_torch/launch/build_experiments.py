"""Regenerate the Dry-run and Roofline tables of EXPERIMENTS.md from the
dry-run's records (the reference package's
``scripts/build_experiments.py``).

Each table replaces the text between its marker (``<!-- DRYRUN_TABLE -->``,
``<!-- ROOFLINE_TABLE -->``) and the next ``<!-- END -->``; a file that
does not exist yet is started with both markers.

  PYTHONPATH=src python -m repro_torch.launch.build_experiments \\
      [--reports reports/dryrun] [--out EXPERIMENTS.md]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.configs import ALL_ARCH_NAMES
from repro_torch.configs.shapes import ALL_SHAPE_NAMES

__all__ = ["dryrun_table", "load", "main", "replace_section",
           "roofline_table"]

MARKERS = ("<!-- DRYRUN_TABLE -->", "<!-- ROOFLINE_TABLE -->")


def load(report_dir="reports/dryrun"):
    recs = {}
    for p in Path(report_dir).glob("*.json"):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_e(x):
    return f"{x:.2e}"


def dryrun_table(recs):
    lines = [
        "| arch | shape | single 16×16 | multi 2×16×16 | args GiB/dev | temp GiB/dev | compile s |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in ALL_ARCH_NAMES:
        for s in ALL_SHAPE_NAMES:
            r1 = recs.get((a, s, "single"))
            r2 = recs.get((a, s, "multi"))
            if r1 is None:
                continue
            if r1["status"] == "skipped":
                lines.append(f"| {a} | {s} | SKIP | SKIP | — | — | — |"
                             f" <!-- {r1['reason'][:60]} -->")
                continue
            st1 = "✅ ok" if r1["status"] == "ok" else "❌"
            st2 = "✅ ok" if (r2 or {}).get("status") == "ok" else "❌"
            mem = r1.get("memory", {})
            lines.append(
                f"| {a} | {s} | {st1} | {st2} | "
                f"{mem.get('argument_size_in_bytes', 0)/2**30:.2f} | "
                f"{mem.get('temp_size_in_bytes', 0)/2**30:.2f} | "
                f"{r1.get('compile_s', 0)} |")
    return "\n".join(lines)


def roofline_table(recs):
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | useful FLOPs ratio |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in ALL_ARCH_NAMES:
        for s in ALL_SHAPE_NAMES:
            r = recs.get((a, s, "single"))
            if r is None or r["status"] != "ok":
                if r is not None and r["status"] == "skipped":
                    lines.append(f"| {a} | {s} | — | — | — | skipped | — |")
                continue
            t = r["terms"]
            lines.append(
                f"| {a} | {s} | {fmt_e(t['compute_s'])} | {fmt_e(t['memory_s'])} | "
                f"{fmt_e(t['collective_s'])} | **{r['dominant'].replace('_s','')}** | "
                f"{r['useful_flops_ratio']:.3f} |")
    return "\n".join(lines)


def replace_section(text, marker, body):
    """Idempotent: replaces marker..<!-- END --> with fresh content."""
    assert marker in text, marker
    i = text.index(marker)
    end = "<!-- END -->"
    j = text.index(end, i) + len(end)
    return text[:i] + marker + "\n\n" + body + "\n" + end + text[j:]


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reports", default="reports/dryrun")
    ap.add_argument("--out", default="EXPERIMENTS.md")
    args = ap.parse_args(argv)
    recs = load(args.reports)
    out = Path(args.out)
    exp = out.read_text() if out.exists() else "".join(
        f"{m}\n<!-- END -->\n\n" for m in MARKERS)
    exp = replace_section(exp, MARKERS[0], dryrun_table(recs))
    exp = replace_section(exp, MARKERS[1], roofline_table(recs))
    out.write_text(exp)
    n_ok = sum(1 for r in recs.values() if r["status"] == "ok")
    n_skip = sum(1 for r in recs.values() if r["status"] == "skipped")
    print(f"tables written: {n_ok} ok cells, {n_skip} skips")
    return exp


if __name__ == "__main__":
    main()
