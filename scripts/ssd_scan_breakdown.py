"""What an SSD-scan call (K4, ``ssd_scan.cu``) spends its time on, at the
dense mamba2-130m prefill shape (b 8, s 2048, nh 24, p 64, n 128, chunk
256, bf16 x/B/C, f32 dt), on the card.

The source is rebuilt with one part of the chunk-state kernel (a) or of
the scan kernel (c) taken out at a time, in copies made in a temporary
directory outside the checkout (the same way as `kernel_mutants.py`), and
each copy is timed as `chip_smoke.py` times K4 (two operand sets
alternating, queued behind a device sleep, median of 21), and by launch
(torch.profiler, 10 calls):

  kernel              the source as it is
  no intra            the intra-chunk products (scores x x) skipped
  no inter            the inter-chunk products (C x the entering state)
  no scores           the pass that turns C B^T into a head's decayed
                      scores skipped
  no state split      the entering state not split into bf16 parts
  no products         all four of the above: loads, cumsums, C B^T, block
                      barriers and y's stores remain
  no products, loads  also no x or state tiles copied
  (a) no x w          (a) skips x w's bf16 parts
  (a) no products     (a) skips its tensor-core products
  (a) no stores       (a) writes no chunk state

The copies that skip work give wrong outputs; only their times are read.

    python3 scripts/ssd_scan_breakdown.py      (needs a CUDA card and nvcc)
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import kernel_mutants as km  # noqa: E402  (also puts src/ on the path)

import chip_smoke  # noqa: E402

NO_INTRA = ("          for (int kb = 0; kb <= rb; ++kb) {",
            "          for (int kb = 0; kb < 0; ++kb) {")
NO_INTER = ("        if (inter) {\n          for (int ks = 0;",
            "        if (false) {\n          for (int ks = 0;")
NO_SCORES = ("      for (int e = tid; e < kBlocks * 128; e += kScanThreads) {",
             "      for (int e = tid; e < 0; e += kScanThreads) {")
NO_SPLIT = ("      if (inter) {\n        constexpr int kMost",
            "      if (false) {\n        constexpr int kMost")
NO_LOADS = ("    copy_rows<kScanThreads>(x_slot(slot), m.xs, xg + head * a.P, "
            "a.x_st, at.valid, a.P);\n    if (inter)",
            "    if (false)\n    copy_rows<kScanThreads>(x_slot(slot), m.xs, "
            "xg + head * a.P, a.x_st, at.valid, a.P);\n    if (false)")
A_NO_XW = ("      for_rows<kThreads>(L, m.Pp / 2, [&](int j, int pair) {",
           "      for_rows<kThreads>(0, m.Pp / 2, [&](int j, int pair) {")
A_NO_PRODUCTS = ("        for (int ks = 0; ks < L / 16; ++ks) {\n          uint32_t ahi[4], alo[4];",
                 "        for (int ks = 0; ks < 0; ++ks) {\n          uint32_t ahi[4], alo[4];")
A_NO_STORES = ("            if (p < a.P)\n              *reinterpret_cast<float2*>(out + p * a.N + n) =",
               "            if (p < 0)\n              *reinterpret_cast<float2*>(out + p * a.N + n) =")
PRODUCTS = [NO_INTRA, NO_INTER, NO_SCORES, NO_SPLIT]
VARIANTS = {
    "kernel": [],
    "no intra": [NO_INTRA],
    "no inter": [NO_INTER],
    "no scores": [NO_SCORES],
    "no state split": [NO_SPLIT],
    "no products": PRODUCTS,
    "no products, loads": PRODUCTS + [NO_LOADS],
    "(a) no x w": [A_NO_XW],
    "(a) no products": [A_NO_PRODUCTS],
    "(a) no stores": [A_NO_STORES],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_scan_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    sets = [chip_smoke.ssd_operands(torch, gen, 8, 2048, 24, 64, 128,
                                    dtype=torch.bfloat16) for _ in range(2)]

    def call(*a):
        return ss.ssd_scan(*a, chunk=256)

    times, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="ssd_scan_breakdown_") as tmp:
        tmp = Path(tmp)
        build.BUILD_DIR = tmp / "build"
        sources = {name: km.patched_copy(tmp, f"v{i}", km.SSD, edits)
                   for i, (name, edits) in enumerate(VARIANTS.items())}
        build.build(list(sources.values()))
        for rnd in range(2):           # two rounds: kernel, ..., kernel, ...
            for name, src in sources.items():
                ss.SOURCE = src
                t = chip_smoke.median_ms(torch, call, sets)
                by = chip_smoke.launch_ms(torch, lambda: call(*sets[0]))
                times.setdefault(name, []).append(t)
                launches.setdefault(name, []).append(by)
                print(f"breakdown round {rnd} {name}: {t:.4f} ms "
                      f"({json.dumps(by)})", flush=True)
    print(json.dumps({"shape": {"b": 8, "s": 2048, "nh": 24, "p": 64,
                                "n": 128, "chunk": 256, "dtype": "bfloat16"},
                      "ms": times, "launch_ms": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
