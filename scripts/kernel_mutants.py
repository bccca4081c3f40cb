"""Hold broken copies of the flash-decode kernels (K1 paged and K3 dense,
one source: ``flash_decode.cu``), the SSD-scan kernel (K4,
``ssd_scan.cu``) and its backward (K4b, ``ssd_scan_bwd.cu``), the grouped
matmul (K2, ``moe_gmm.cu``), the row gather
(K5a, ``coro_gather.cu``), the scatter-add (K6, ``scatter_add.cu``) and the
STREAM triad (K7, ``triad.cu``) to the tolerances ``chip_smoke.py`` holds
the real ones to, on the card (K5a and K6 bitwise, K7 in f32 too).

Each broken copy ("mutant") is one or a few textual changes to a copy of
the source, made in a temporary directory outside the checkout and built
there with nvcc; the wrapper is pointed at it, and its output is compared
with the plain PyTorch version on the inputs `chip_smoke.py` uses (a
mutant that breaks one path of a kernel runs on that path's cases only).
A tolerance is worth something only if every mutant fails it; the
unchanged source runs first, as a control, and must pass. Outputs are
allocated over freed NaN blocks, so an element a mutant never writes
cannot hold an earlier result. The kernel wrappers run under the guard
(`core.guard`) in strict mode: a kernel is held at the depth and grid its
wrapper picks, with no ladder to retry it at another (where a broken
walk can come out right), and a mutant whose output the guard's scan
finds non-finite raises `KernelNumericsError`, which counts as a failure;
a mutant that does not build or load aborts the script.

    python3 scripts/kernel_mutants.py      (needs a CUDA card and nvcc)

Prints one line per (mutant, case) and a JSON summary; exits 1 if the
control fails anywhere or any mutant passes anywhere.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (its tolerances and operands)

FLASH = "decode_attention/csrc/flash_decode.cu"
SSD = "ssd_scan/csrc/ssd_scan.cu"
SSD_BWD = "ssd_scan/csrc/ssd_scan_bwd.cu"
GMM = "moe_gmm/csrc/moe_gmm.cu"
GATHER = "coro_gather/csrc/coro_gather.cu"
SCATTER = "coro_scatter_add/csrc/scatter_add.cu"
TRIAD = "stream_copy/csrc/triad.cu"
PAGED_KEYS = "return max(0, min(lengths[b], M * page));"
SSD_INTRA_BF16 = ("          for (int kb = 0; kb <= rb; ++kb) {",
                  "          for (int kb = 0; kb < 0; ++kb) {")
SSD_INTRA_F32 = ("        for (int j = 0; j < i0 + 4; ++j) {",
                 "        for (int j = 0; j < 0; ++j) {")

# name -> (source, the text replaced, its replacement), or (source, [(text,
# replacement), ...], the substring that picks the cases it runs on)
MUTANTS = {
    "K1 page looked up one table entry late": (
        FLASH, "smem_table[i] = row_bt[min(r.page0 + i, M - 1)];",
        "smem_table[i] = row_bt[min(r.page0 + i + 1, M - 1)];"),
    "K1 last live key of each request dropped": (
        FLASH, PAGED_KEYS, "return max(0, min(lengths[b], M * page) - 1);"),
    "K1 every request at request 0's length": (
        FLASH, PAGED_KEYS, "return max(0, min(lengths[0], M * page));"),
    "K3 merge without exp(m_i - m)": (
        FLASH, "const float w = exp2f(m_i - M);", "const float w = 1.f;"),
    "K3 last row of each split dropped": (
        FLASH, "const int row_end = min(n_keys, row0 + tiles_per_split * blk);",
        "const int row_end = min(n_keys, row0 + tiles_per_split * blk) - 1;"),
    "K3 one row past pos": (
        FLASH, "static_cast<int>(pos + 1 < S ? pos + 1 : S);",
        "static_cast<int>(pos + 2 < S ? pos + 2 : S);"),
    "K4 intra-chunk term dropped": (
        SSD, [SSD_INTRA_BF16, SSD_INTRA_F32], ""),
    "K4 inter-chunk term dropped": (
        SSD, "const bool inter = at.c > 0;", "const bool inter = false;"),
    "K4 state not decayed between chunks": (
        SSD, "const float decay = expf(tot[static_cast<size_t>(c) * a.NH]);",
        "const float decay = 1.f;"),
    "K4 last chunk dropped": (
        SSD, "const dim3 grid((a.NH + a.group - 1) / a.group, a.chunks, Bsz);",
        "const dim3 grid((a.NH + a.group - 1) / a.group, a.chunks - 1, Bsz);"),
    "K4 one head group's C B^T from the wrong sequence": (
        SSD, "copy_rows<kScanThreads>(bt, m.bs, static_cast<const T*>(a.B) + at.b * a.b_sb",
        "copy_rows<kScanThreads>(bt, m.bs, static_cast<const T*>(a.B) + "
        "((at.b + (blockIdx.x == 0)) % gridDim.z) * a.b_sb"),
    # caught only under a weak decay: at the others a 64-row chunk keeps
    # under 1e-4 of its state, so what is carried across chunks is below
    # the tolerance
    "K4b gradient of the state not carried back between chunks": (
        SSD_BWD, [("if (t + 1 < C) fma8(h, expf(f[u]), v[u]);",
                   "if (t + 1 < C) fma8(h, back ? 0.f : expf(f[u]), v[u]);")], "weak decay"),
    "K4b state entering a chunk not carried from the chunk before": (
        SSD_BWD, [("if (t + 1 < C) fma8(h, expf(f[u]), v[u]);",
                   "if (t + 1 < C) fma8(h, back ? expf(f[u]) : 0.f, v[u]);")], "weak decay"),
    "K4b dA and ddt without the reverse cumsum": (
        SSD_BWD, "      scan64(&dcs[0], &dcs[1], true);\n", ""),
    "K4b intra-chunk term of dx dropped": (
        SSD_BWD, "mma_tile<true, true>(in, Sop, Yop, jb * 16, cp * 16, jb * 16, kL);",
        "mma_tile<true, true>(in, Sop, Yop, jb * 16, cp * 16, kL, kL);"),
    "K4b inter-chunk term of dC dropped from one lane of four": (
        SSD_BWD, "dct[t][s][e] = fmaf(ecs_s[i], yhv[s][e], dct[t][s][e]);",
        "dct[t][s][e] = tig ? fmaf(ecs_s[i], yhv[s][e], dct[t][s][e]) : dct[t][s][e];"),
    # every case's group holds more than one head
    "K4b a head's dB written over its group's, not added": (
        SSD_BWD, "dbt[t][s][e] = fmaf(w_s[j], xgv[s][e], dbt[t][s][e]);",
        "dbt[t][s][e] = w_s[j] * xgv[s][e];"),
    # the first head group's B tile, from which C B^T is hoisted once for
    # the group, from the next chunk (at s 512 every chunk is whole)
    "K4b C B^T hoisted from the wrong chunk": (
        SSD_BWD, [("m.Pp, m.hs, P, N);\n    }\n  }\n  copy_rows<kThreads>(bt, m.bs, "
                   "static_cast<const T*>(a.B) + at.b * a.b_sb + at.t0 * a.b_st,",
                   "m.Pp, m.hs, P, N);\n    }\n  }\n  copy_rows<kThreads>(bt, m.bs, "
                   "static_cast<const T*>(a.B) + at.b * a.b_sb + "
                   "(at.grp ? at.t0 : (at.c + 1) % a.chunks * kL) * a.b_st,")],
        "s=512"),
    # bf16 path: the states' low parts (~8 bits past bf16's) dropped from
    # every product with H or G; seen through ddt, whose terms are ~100x
    # its smaller values
    "K4b a split operand's low part dropped": (
        SSD_BWD, [("    if (B.lo) {\n      uint32_t bl[4];",
                   "    if (false) {\n      uint32_t bl[4];")], "bfloat16"),
    "K7 items dealt with the wrong stride": (
        TRIAD, "const int64_t off = static_cast<int64_t>(blockIdx.x) * units;",
        "const int64_t off = static_cast<int64_t>(blockIdx.x) * (units - 1);"),
    "K7 last item not launched": (
        TRIAD, "kernel<<<static_cast<unsigned>(items), kThreads",
        "kernel<<<static_cast<unsigned>(items - 1), kThreads"),
    "K7 s not applied on the unit path": (
        TRIAD, [("a[off + u] = repro::axpy_unit<T, V, true>(b[off + u], c[off + u], s);",
                 "a[off + u] = repro::axpy_unit<T, V, false>(b[off + u], c[off + u], s);")],
        "unit path"),
    "K7 an item's last 16 bytes not stored on the bulk path": (
        TRIAD, [("    for (int u = tid; u < units; u += kThreads)\n      repro::st_global_cs(",
                 "    for (int u = tid; u < units - 1; u += kThreads)\n      repro::st_global_cs(")],
        "[2^20, 128]"),
    "K2 a block's last tile dropped": (
        GMM, "return (tiles - b + blocks - 1) / blocks * per_tile;",
        "return ((tiles - b + blocks - 1) / blocks - (b + blocks < tiles)) * per_tile;"),
    "K2 tiles dealt with the wrong stride": (
        GMM, "return b + i / per_tile * blocks;",
        "return b + i / per_tile * (blocks - 1);"),
    "K2 a tile stored one k-slice early": (
        GMM, "if ((i + 1) % walk.per_tile == 0) {",
        "if ((i + 2) % walk.per_tile == 0) {"),
    "K5a a row id prefetched for the wrong tile": (
        GATHER, "if (i + depth + 1 < count) fetch(t + depth + 1);",
        "if (i + depth + 1 < count) fetch(t + depth);"),
    "K6 write-back at the row ids of the tile issued next": (
        SCATTER, "V* dst = row(back, j);", "V* dst = row(next, j);"),
    "K6 a block's last tile dropped": (
        SCATTER, "for (int64_t i = 0; i < count; ++i) {",
        "for (int64_t i = 0; i < count - 1; ++i) {"),
    # the race at its worst: the slot's next tile lands before it is read
    "K6 a slot reissued before its write-back has read it": (
        SCATTER, "    write_back(t, slot);\n"
        "    if (i + depth < count) issue(t + depth, slot);\n",
        "    if (i + depth < count) issue(t + depth, slot);\n"
        "    repro::cp_async_commit();\n    repro::cp_async_wait<0>();\n"
        "    write_back(t, slot);\n"),
    "K6 update taken from the next slot": (
        SCATTER, "const Slot* up = cur + tile_units;",
        "const Slot* up = ring + static_cast<size_t>((slot + 1) % depth) * 2 "
        "* tile_units + tile_units;"),
}

patched_copy = chip_smoke.patched_copy


def edits_of(spec):
    """(source, [(text, replacement), ...], case filter) of a mutant."""
    if isinstance(spec[1], list):
        return spec
    rel, old, new = spec
    return rel, [(old, new)], ""


def make_copies(tmp: Path):
    """{name: mutated source path}."""
    out = {}
    for i, (name, spec) in enumerate(MUTANTS.items()):
        rel, edits, _ = edits_of(spec)
        out[name] = patched_copy(tmp, f"m{i}", rel, edits)
    return out


def nan_block(torch, shape, dtype) -> None:
    """Free a NaN block of `shape` for the next output of that size to
    reuse (the caching allocator hands it back)."""
    block = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
    del block


def k3_cases(torch):
    """yi-6b's heads (H 32, KH 4, D 128) and paligemma-3b's (H 8, KH 1,
    D 256) over S 1056: B 8 pos 1040 (the dense path's decode shape) and
    B 3 pos 528, f32 and bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for h, kh, d in ((32, 4, 128), (8, 1, 256)):
        for b, pos in ((8, 1040), (3, 528)):
            base = [torch.randn(*shape, generator=gen, device="cuda")
                    for shape in ((b, h, d), (b, 1056, kh, d),
                                  (b, 1056, kh, d))]
            for dtype_name in ("float32", "bfloat16"):
                args = [t.to(getattr(torch, dtype_name)) for t in base]
                yield (f"H={h} KH={kh} D={d} B={b} pos={pos} {dtype_name}",
                       args, pos, dtype_name)


def k1_cases(torch):
    """yi-6b's heads (H 32, KH 4, D 128) over 16-row pages: phase 6's
    timing shape (B 5, mid-generation lengths 132-272, a table of 18
    pages) and a ragged B 3 (lengths 1, 300, 517), f32 and bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for lengths, m in (([132, 181, 207, 244, 272], 18), ([1, 300, 517], 33)):
        base = chip_smoke.paged_problem(torch, gen, lengths, h=32, kh=4, d=128,
                                        blk=16, dtype=torch.float32,
                                        device="cuda", pad_row=False)
        q, kp, vp, bt, ln = base
        bt = torch.nn.functional.pad(bt, (0, m - bt.shape[1])).contiguous()
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            yield (f"B={len(lengths)} M={m} lengths={lengths} {dtype_name}",
                   (q.to(dtype), kp.to(dtype), vp.to(dtype), bt, ln),
                   dtype_name)


def k4_cases(torch):
    """mamba2-130m's prefill shape (b 8, s 2048, nh 24, p 64, n 128, chunk
    256), x/B/C in f32 and in bf16, dt f32, and a sequence off the
    kernel's chunk (s 1984: the last chunk partial) in bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for s, dtype_name in ((2048, "float32"), (2048, "bfloat16"),
                          (1984, "bfloat16")):
        args = chip_smoke.ssd_operands(torch, gen, 8, s, 24, 64, 128,
                                       dtype=getattr(torch, dtype_name))
        yield f"b=8 s={s} x/B/C {dtype_name}", args, dtype_name


def k4b_cases(torch):
    """K4's backward at mamba2-130m's training shape (b 8, s 512, nh 24,
    p 64, n 128, chunk 256) in bf16 at the solved depth (one slot a block),
    at hymba-1.5b's (nh 50, p 64, n 16) in f32 at depth 2 with dh_final
    given, and off the kernel's chunk (s 480, chunk 32: the last 64-row
    chunk partial) in f32 at depth 5, and at mamba2's shape under a weak
    decay (dt in [0.005, 0.03)) in f32 at depth 2."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    for name, s, nh, p, n, chunk, dtype_name, depth, with_dh in (
            ("mamba2 train", 512, 24, 64, 128, 256, "bfloat16", None, False),
            ("hymba train", 512, 50, 64, 16, 256, "float32", 2, True),
            ("s off the chunk", 480, 24, 64, 128, 32, "float32", 5, True),
            ("weak decay", 512, 24, 64, 128, 256, "float32", 2, True)):
        dtype = getattr(torch, dtype_name)
        args = chip_smoke.ssd_operands(torch, gen, 8, s, nh, p, n,
                                       dtype=dtype, weak=name == "weak decay")
        dy = torch.randn(8, s, nh, p, generator=gen, device="cuda").to(dtype)
        dh = torch.randn(8, nh, p, n, generator=gen, device="cuda") \
            if with_dh else None
        yield (f"{name} b=8 s={s} nh={nh} {dtype_name} depth={depth}",
               args, dy, dh, chunk, depth, dtype_name)


def k7_cases(torch):
    """[2^20, 128] arrays (512 MiB each) at the wrapper's plan, f32 and
    bf16; the unit path at 4-byte (64 x 3 f32) and 2-byte units (63 x 3
    bf16)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    for dtype in (torch.float32, torch.bfloat16):
        b, c = (torch.randn(1 << 20, 128, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        yield f"{str(dtype)[6:]} [2^20, 128]", b, c, 128
    for dtype, n, rows in ((torch.float32, 64, 2), (torch.bfloat16, 63, 1)):
        b, c = (torch.randn(n, 3, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        yield f"{str(dtype)[6:]} {n}x3 unit path", b, c, rows


def k2_cases(torch):
    """qwen3-moe's decode gate/up (tokens shared at stride 0) at the
    wrapper's grid (two tiles a block) and down at 5 blocks an SM (3 or 4
    tiles a block), and three [2048, 128] tiles of one expert over two
    blocks; f32 and bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, e, c, dm, f, shared, blocks in (
            ("decode gate/up E=128 C=5, the wrapper's grid", 128, 5, 2048,
             768, True, None),
            ("decode down E=128 C=5, 5 blocks an SM", 128, 5, 768, 2048,
             False, 5 * sm),
            ("three tiles over 2 blocks E=1 C=5", 1, 5, 2048, 384, True, 2)):
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            tokens, w = chip_smoke.gmm_operands(torch, gen, e, c, dm, f,
                                                shared, dtype)
            yield f"{name} {dtype_name}", tokens, w, blocks, dtype_name


def k5a_cases(torch):
    """2^18 row ids over a [2^16, 128] table of 512 B rows (f32, int32)
    and 256 B rows (bf16), at the solved split and at 4x14, 6x9, 8x6 and
    12x4 blocks per SM x slots."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    idx = torch.randint(0, 1 << 16, (1 << 18,), generator=gen, device="cuda",
                        dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        table = (torch.randn(1 << 16, 128, generator=gen, device="cuda")
                 * 100).to(dtype)
        for split in (None, (4, 14), (6, 9), (8, 6), (12, 4)):
            yield f"{str(dtype)[6:]} split={split}", table, idx, split


def k6_cases(torch):
    """2^17 distinct rows of a [2^18, 128] table (512 B rows in f32, 256 B
    in bf16; 16384 tiles, so that every block at every split walks more
    tiles than it has slots and refills one), at the solved split and at
    K6_SPLITS."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    uniq = torch.randperm(1 << 18, generator=gen, device="cuda")[:1 << 17] \
        .int()
    for dtype in (torch.float32, torch.bfloat16):
        table, upd = ((torch.randn(rows, 128, generator=gen, device="cuda")
                       * 10).to(dtype) for rows in (1 << 18, 1 << 17))
        for split in (None, *chip_smoke.K6_SPLITS):
            yield f"{str(dtype)[6:]} split={split}", table, uniq, upd, split


def within(torch, got, want, atol, rtol) -> bool:
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and bool(
        torch.allclose(got, want, atol=atol, rtol=rtol))


def caught(fn):
    """`fn()`, or None when the guard's checks of the output raised (the
    scan found it non-finite, or the sentinel found it off its plain
    version). Any other failure, a mutant that does not build or load
    included, propagates and fails the script."""
    from repro_torch.core.guard import KernelNumericsError, KernelParityError

    try:
        return fn()
    except (KernelNumericsError, KernelParityError) as e:
        print(f"MUT   raised {type(e).__name__}: {e}", flush=True)
        return None


def run(torch, kernel: str, source, only: str = ""):
    """[(case, max_abs_err, passed)] of the kernel built from `source`, on
    the cases whose name holds `only`."""
    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.kernels.stream_copy import stream_copy as sc

    rows = []
    if kernel == "K7":
        sc.SOURCE = source
        for case, b, c, rows_ in k7_cases(torch):
            if only not in case:
                continue
            nan_block(torch, b.shape, b.dtype)
            got = caught(lambda: sc.triad(b, c, 3.0, rows=rows_))
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            want = sc.triad_plain(b, c, 3.0)
            err = float((got.float() - want.float()).abs().max())
            ok = bool(torch.equal(got, want)) if b.dtype == torch.float32 \
                else within(torch, got, want, *(chip_smoke.TRIAD_TOL[
                    "bfloat16"],) * 2)
            rows.append((case, err, ok))
    elif kernel == "K2":
        mg.SOURCE = source
        for case, tokens, w, blocks, dtype_name in k2_cases(torch):
            tol = chip_smoke.TOL[dtype_name]
            nan_block(torch, (tokens.shape[0], tokens.shape[1], w.shape[2]),
                      tokens.dtype)
            got = caught(lambda: mg.gmm(tokens, w, depth=2)) \
                if blocks is None else \
                mg.gmm_at(tokens, w, depth=2, blocks=blocks)
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            want = mg.gmm_plain(tokens, w)
            err = float((got.float() - want.float()).abs().max())
            rows.append((case, err, within(torch, got, want, tol, tol)))
    elif kernel == "K5a":
        cg.SOURCE = source
        for case, table, idx, split in k5a_cases(torch):
            got = caught(lambda: cg.row_gather(table, idx)) \
                if split is None else \
                cg.row_gather_at(table, idx, blocks_per_sm=split[0],
                                 slots=split[1])
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            want = cg.row_gather_plain(table, idx)
            err = float((got.float() - want.float()).abs().max())
            rows.append((case, err, bool(torch.equal(got, want))))
    elif kernel == "K6":
        sa.SOURCE = source
        for case, table, uniq, upd, split in k6_cases(torch):
            want = sa.scatter_add_unique_plain(table.clone(), uniq, upd)
            got = caught(lambda: sa.scatter_add_unique(table.clone(), uniq,
                                                       upd)) \
                if split is None else sa.scatter_add_at(
                    table.clone(), uniq, upd, blocks_per_sm=split[0],
                    slots=split[1])
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            err = float((got.float() - want.float()).abs().max())
            rows.append((case, err, bool(torch.equal(got, want))))
    elif kernel == "K1":
        da.FLASH_SOURCE = source
        for case, args, dtype_name in k1_cases(torch):
            got = caught(lambda: da.paged_flash_decode(*args))
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            want = da.paged_flash_decode_plain(*args)
            atol, rtol = chip_smoke.DECODE_TOL[dtype_name]
            err = float((got.float() - want.float()).abs().max())
            rows.append((case, err, within(torch, got, want, atol, rtol)))
    elif kernel == "K3":
        da.FLASH_SOURCE = source
        for case, (q, k, v), pos, dtype_name in k3_cases(torch):
            got = caught(lambda: da.flash_decode(q, k, v, pos))
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            want = da.flash_decode_plain(q, k, v, pos)
            atol, rtol = chip_smoke.DECODE_TOL[dtype_name]
            err = float((got.float() - want.float()).abs().max())
            rows.append((case, err, within(torch, got, want, atol, rtol)))
    elif kernel == "K4b":
        ss.BWD_SOURCE = source
        for case, args, dy, dh, chunk, depth, dtype_name in k4b_cases(torch):
            if only not in case:
                continue
            nan_block(torch, args[0].shape, args[0].dtype)
            got = caught(lambda: ss.ssd_scan_bwd(*args, dy, dh, chunk=chunk,
                                                 depth=depth))
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            want = ss.ssd_scan_bwd_plain(*args, dy, dh, chunk=chunk)
            tol = chip_smoke.TOL[dtype_name]
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
            ok = all(within(torch, a, b, tol, tol) for a, b in zip(got, want))
            rows.append((case, err, ok))
    else:
        ss.SOURCE = source
        for case, args, dtype_name in k4_cases(torch):
            x = args[0]
            nan_block(torch, x.shape, x.dtype)
            nan_block(torch, (x.shape[0], x.shape[2], x.shape[3],
                              args[3].shape[2]), torch.float32)
            got = caught(lambda: ss.ssd_scan(*args, chunk=64))
            if got is None:
                rows.append((case, float("nan"), False))
                continue
            y, h = got
            ry, rh = ss.ssd_scan_plain(*args, chunk=64)
            tol_y, tol_h = chip_smoke.TOL[dtype_name], chip_smoke.TOL["float32"]
            err = max(float((y.float() - ry.float()).abs().max()),
                      float((h - rh).abs().max()))
            ok = within(torch, y, ry, tol_y, tol_y) and \
                within(torch, h, rh, tol_h, tol_h)
            rows.append((case, err, ok))
    torch.cuda.synchronize()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_mutants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import guard
    from repro_torch.kernels import build
    from repro_torch.kernels.coro_gather import coro_gather as cg
    from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.moe_gmm import moe_gmm as mg
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.kernels.stream_copy import stream_copy as sc

    controls = {"K1": da.FLASH_SOURCE, "K3": da.FLASH_SOURCE, "K4": ss.SOURCE,
                "K4b": ss.BWD_SOURCE, "K2": mg.SOURCE, "K5a": cg.SOURCE,
                "K6": sa.SOURCE, "K7": sc.SOURCE}
    guard.set_strict(True)
    bad = []
    summary = {}
    with tempfile.TemporaryDirectory(prefix="kernel_mutants_") as tmp:
        tmp = Path(tmp)
        build.BUILD_DIR = tmp / "build"
        mutants = make_copies(tmp)
        build.build(list(dict.fromkeys([*controls.values(),
                                        *mutants.values()])))
        for kernel, source in controls.items():
            for case, err, ok in run(torch, kernel, source):
                print(f"MUT control {kernel} {case}: err={err:.3e} "
                      f"{'pass' if ok else 'FAIL'}", flush=True)
                if not ok:
                    bad.append(f"control {kernel} {case}")
        for name, source in mutants.items():
            verdicts = []
            only = edits_of(MUTANTS[name])[2]
            for case, err, ok in run(torch, name.split()[0], source, only):
                print(f"MUT {name} {case}: err={err:.3e} "
                      f"{'pass' if ok else 'FAIL'}", flush=True)
                verdicts.append("pass" if ok else "FAIL")
                if ok:
                    bad.append(f"{name} {case}")
            summary[name] = verdicts
    print(json.dumps({"mutants": summary, "caught": not bad}), flush=True)
    if bad:
        print("not caught: " + "; ".join(bad), file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
