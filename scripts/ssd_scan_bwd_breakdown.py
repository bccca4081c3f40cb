"""What a call of K4's backward (``ssd_scan_bwd.cu``) spends its time on,
at mamba2-130m's and hymba-1.5b's training shapes (b 8, s 512, chunk 256;
x/B/C bf16 slices of one projection, dt f32, dh_final None), on the card.

The source is rebuilt with one part of the state kernel (a) or of the
chunk kernel (c) taken out at a time, in copies made in a temporary
directory outside the checkout (the same way as `kernel_mutants.py`), and
each copy is timed as `chip_smoke.py` times K4's backward (two operand sets
alternating, queued behind a device sleep, median of 21), and by launch
(torch.profiler, 10 calls):

  kernel                  the source as it is
  (c) no dM               the scores' product dy x^T skipped
  (c) no dx products      M^T dy and G B skipped
  (c) no inter products   dy H and x G skipped
  (c) no <G, H>           the state's dot product skipped
  (c) no products         all of (c)'s products (C B^T and dS's with B and
                          C too): loads, cumsums, the scores' elementwise
                          pass, barriers and stores remain
  (c) no products, states also no state tiles copied
  (a) no products         (a) skips its tensor-core products
  (a) no stores           (a) writes no chunk state

The copies that skip work give wrong outputs; only their times are read.

    python3 scripts/ssd_scan_bwd_breakdown.py      (needs a CUDA card and nvcc)
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import kernel_mutants as km  # noqa: E402  (also puts src/ on the path)

import chip_smoke  # noqa: E402

NO_DM = ("      mma_tile<false, false>(dm, Yop, Xop, rb * 16, kb * 16, 0, m.Pp);\n",
         "")
NO_DX = ("        mma_tile<true, true>(in, Sop, Yop, jb * 16, cp * 16, jb * 16, kL);\n"
         "        mma_tile<false, false>(gb, Bop, Gop, jb * 16, cp * 16, 0, m.Np);\n",
         "")
NO_YH = ("        mma_tile<false, true>(yhv, Yop, Hop, ib * 16, np * 16, 0, m.Pp);\n",
         "")
NO_XG = ("      mma_tile<false, true>(xgv, Xop, Gop, ib * 16, np * 16, 0, m.Pp);\n",
         "")
NO_GH = ("    if (inter) {\n      constexpr int kV = kF32 ? 4 : 8;",
         "    if (false) {\n      constexpr int kV = kF32 ? 4 : 8;")
NO_CB = ("  if (lower) mma_tile<false, false>(cb, Cop, Bop, rb * 16, kb * 16, 0, m.Np);",
         "")
NO_DS = ("    mma_tile<false, true>(dct[t], Sop, Bop, ib * 16, np * 16, 0, (ib + 1) * 16);\n"
         "    mma_tile<true, true>(dbt[t], Sop, Cop, ib * 16, np * 16, ib * 16, kL);\n",
         "")
NO_STATES = ("    copy_state(g_slot(slot), a.dstates + st);\n"
             "    if (inter) copy_state(h_slot(slot), a.states + st);\n",
             "")
A_NO_PRODUCTS = ("      mma_tile<true, true>(acc, is_d ? Yw : Xw, is_d ? Cop : Bop, mt * 16, "
                 "np * 16, 0, kL);\n", "")
A_NO_STORES = ("          if (p < P)\n            *reinterpret_cast<float2*>(out + p * N + n) =",
               "          if (p < 0)\n            *reinterpret_cast<float2*>(out + p * N + n) =")
PRODUCTS = [NO_DM, NO_DX, NO_YH, NO_XG, NO_GH, NO_CB, NO_DS]
VARIANTS = {
    "kernel": [],
    "(c) no dM": [NO_DM],
    "(c) no dx products": [NO_DX],
    "(c) no inter products": [NO_YH, NO_XG],
    "(c) no <G, H>": [NO_GH],
    "(c) no products": PRODUCTS,
    "(c) no products, states": PRODUCTS + [NO_STATES],
    "(a) no products": [A_NO_PRODUCTS],
    "(a) no stores": [A_NO_STORES],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_scan_bwd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ring
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    shapes = {arch: chip_smoke.ssd_train_shape(arch)
              for arch, _ in chip_smoke.SSM_TRAIN}
    sets = {arch: [chip_smoke.ssd_grad_operands(torch, gen, arch,
                                                torch.bfloat16)
                   for _ in range(2)] for arch in shapes}

    times, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="ssd_scan_bwd_breakdown_") as tmp:
        tmp = Path(tmp)
        build.BUILD_DIR = tmp / "build"
        sources = {name: km.patched_copy(tmp, f"v{i}", km.SSD_BWD, edits)
                   for i, (name, edits) in enumerate(VARIANTS.items())}
        build.build(list(sources.values()))
        for rnd in range(2):           # two rounds: kernel, ..., kernel, ...
            for name, src in sources.items():
                ss.BWD_SOURCE = src
                for arch, (b, s, nh, p, n, chunk) in shapes.items():
                    run = ss.bwd_plan(b, s, nh, p, n, 2, 2,
                                      sms=ring.sm_count(torch.device("cuda")))

                    def call(*a):
                        return ss.ssd_scan_bwd_at(*a, chunk=chunk,
                                                  depth=run.depth)

                    args = [(*a, dy, dh) for a, dy, dh in sets[arch]]
                    t = chip_smoke.median_ms(torch, call, args)
                    by = chip_smoke.launch_ms(torch, lambda: call(*args[0]))
                    key = f"{arch} {name}"
                    times.setdefault(key, []).append(t)
                    launches.setdefault(key, []).append(by)
                    print(f"breakdown round {rnd} {key}: {t:.4f} ms "
                          f"({json.dumps(by)})", flush=True)
    print(json.dumps({"shapes": shapes, "dtype": "bfloat16", "ms": times,
                      "launch_ms": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
