"""Benchmark harness: one table per paper figure + the kernel bench.

Prints ``name,us_per_call,derived`` CSV summary lines, the headline
reproduction line, then each full table. Figure tables come from the
calibrated performance model (`core.sim`), the same on any device; the
``kernel_bench`` section is `launch.kernel_bench`'s tables on the device
given (``--device``, the GPU by default). The ``roofline`` section reads
the dry-run's records (``reports/dryrun``, written by
`repro_torch.launch.dryrun`; no records, no rows).

  python -m repro_torch.launch.figures.run
  python -m repro_torch.launch.figures.run --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from repro_torch.core import sim
from repro_torch.launch.figures import (
    fig11_compiler,
    fig12_latency,
    fig13_instructions,
    fig14_breakdown,
    fig15_optimizations,
    fig16_mlp,
    roofline,
)

__all__ = ["headline", "main"]

def headline() -> str:
    """The headline reproduction line: CoroAMU-Full's average speedup at
    200 and 800 ns, and GUPS at 800 ns, beside the paper's."""
    f200 = sim.average_speedup("coroamu-full", latency_ns=200)
    f800 = sim.average_speedup("coroamu-full", latency_ns=800)
    g = sim.BENCHES["GUPS"]
    return (f"headline,0,full@200={f200:.2f}x(paper3.39) "
            f"full@800={f800:.2f}x(paper4.87) "
            f"GUPS@800={sim.speedup('coroamu-full', g, latency_ns=800):.1f}x"
            f"(paper59.8)")


def main(argv: Optional[Sequence[str]] = None) -> str:
    from repro_torch.launch import kernel_bench
    from repro_torch.serve.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sections = [
        ("fig11_compiler_x86", fig11_compiler.table),
        ("fig12_latency_speedup", fig12_latency.table),
        ("fig13_instruction_expansion", fig13_instructions.table),
        ("fig14_cycle_breakdown", fig14_breakdown.table),
        ("fig15_compiler_opts", fig15_optimizations.table),
        ("fig16_mlp", fig16_mlp.table),
        ("kernel_bench", lambda: kernel_bench.table(device)),
        ("roofline", roofline.table),
    ]
    lines = ["name,us_per_call,derived"]
    bodies = []
    for name, fn in sections:
        t0 = time.perf_counter()
        body = fn()
        us = (time.perf_counter() - t0) * 1e6
        lines.append(f"{name},{us:.0f},rows={body.count(chr(10)) - 1}")
        bodies.append((name, body))
    lines.append(headline())
    text = "\n".join(lines) + "\n"
    for name, body in bodies:
        text += f"\n== {name} ==\n{body}"
    print(text, end="")
    return text


if __name__ == "__main__":
    main()
