"""What a dense flash-decode call (K3, ``flash_decode.cu``) spends its time
on, at the dense yi-6b decode shape (B 8, H 32, KH 4, D 128, S 1056, pos
1040, bf16), on the card.

The source is rebuilt with one part taken out at a time, in copies made in
a temporary directory outside the checkout (the same way as
`kernel_mutants.py`), and each copy is timed as `chip_smoke.py` times K3
(one call per layer's cache, queued behind a device sleep, median of 21):

  kernel              the source as it is
  no PDL              both launches without programmatic dependent launch
  unpadded scratch    the warps' merge scratch without its 8 floats of row
                      padding
  no loads            the K/V tiles are not copied (compute on stale
                      shared memory)
  no compute          the tiles are copied, no scores or P V
  fixed costs         neither loads nor compute: launches, query, ring
                      loop, epilogue, partials and merge
  no epilogue         fixed costs without the block's merge and writes
  empty               the split pass returns at once (its launch and the
                      merge's)

The copies that skip work give wrong outputs; only their times are read.

    python3 scripts/flash_decode_breakdown.py      (needs a CUDA card and nvcc)
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import kernel_mutants as km  # noqa: E402  (also puts src/ on the path)

import chip_smoke  # noqa: E402

NO_PDL = ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")
UNPAD = ("constexpr int kAccPad = 8;", "constexpr int kAccPad = 0;")
NO_LOADS = ("      cp_async16(ks + row * kStride + col, k_cache + src);\n"
            "      cp_async16(vs + row * kStride + col, v_cache + src);",
            "      (void)src;")
NO_COMPUTE = ("      st.chunk(ks + c * kStride, vs + c * kStride, "
              "min(kChunkRows, rows - c), scale_log2, lane);", "      ;")
NO_EPILOGUE = ("  st.store(sm_m + warp * kWP, sm_l + warp * kWP, "
               "sm_acc + warp * kWP * (D + kAccPad), lane);\n  __syncthreads();",
               "  if (blk > 0) return;")
EMPTY = ('  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n',
         '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n'
         "  if (blk > 0) return;\n")
VARIANTS = {
    "kernel": [],
    "no PDL": [NO_PDL],
    "unpadded scratch": [UNPAD],
    "no loads": [NO_LOADS],
    "no compute": [NO_COMPUTE],
    "fixed costs": [NO_LOADS, NO_COMPUTE],
    "no epilogue": [NO_LOADS, NO_COMPUTE, NO_EPILOGUE],
    "empty": [EMPTY],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_decode_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention as da

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    b, s, pos = 8, 1056, 1040
    dev_pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    layers = [tuple(torch.randn(*shape, generator=gen, device="cuda")
                    .to(torch.bfloat16)
                    for shape in ((b, 32, 128), (b, s, 4, 128),
                                  (b, s, 4, 128))) + (dev_pos,)
              for _ in range(32)]
    bound_ms = chip_smoke.flash_decode_bound(b, 32, 4, 128, pos)[0]
    times = {}
    with tempfile.TemporaryDirectory(prefix="flash_decode_breakdown_") as tmp:
        tmp = Path(tmp)
        build.BUILD_DIR = tmp / "build"
        sources = {name: km.patched_copy(tmp, f"v{i}", km.FLASH, edits)
                   for i, (name, edits) in enumerate(VARIANTS.items())}
        build.build(list(sources.values()))
        for rnd in range(2):           # two rounds: kernel, ..., kernel, ...
            for name, src in sources.items():
                da.FLASH_SOURCE = src
                t = chip_smoke.median_ms(torch, da.flash_decode, layers)
                times.setdefault(name, []).append(t)
                print(f"breakdown round {rnd} {name}: {t:.6f} ms, "
                      f"{bound_ms / t:.1%} of the bound", flush=True)
    print(json.dumps({"shape": {"B": b, "H": 32, "KH": 4, "D": 128, "S": s,
                                "pos": pos, "blk": da.FLASH_BLK},
                      "bound_ms": bound_ms, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
