"""Dense flash-decode (K3) in the PyTorch port against the JAX reference.

The port's plain version (what the `flash_decode` wrapper runs on CPU
tensors) is held to the reference's Pallas kernel in interpret mode and to
its oracle `decode_attention_ref`, on the same numpy inputs, at the
reference tests' tolerances: 2e-5 in f32, 3e-2 in bf16. The port's
`_single_decode` / `decode_attention` (the dense engine's decode
attention: in-place row write, then K3) are held to the reference's, and
`decode_spec` must give the reference's context bytes and solved depth
under one shared MachineModel. The CUDA kernel itself is checked against
the plain version on the card (`test_torch_kernels_cuda.py`).
"""
import dataclasses
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.kernels.decode_attention import decode_attention as ref_da
from repro.kernels.decode_attention.ops import decode_attention as ref_op
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.models import common as ref_common
from repro.sharding import NULL_CTX
from repro_torch.core import autotune, machine
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.decode_attention import decode_attention as da
from repro_torch.kernels.decode_attention import ops
from repro_torch.models import common
from repro_torch.sharding import NULL_CTX as PORT_NULL_CTX

TOL = 2e-5


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _problem(seed, b, h, kh, d, s, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, d).astype(dtype), rng.randn(b, s, kh, d).astype(dtype),
            rng.randn(b, s, kh, d).astype(dtype))


def _port(q, k, v, pos, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return da.flash_decode(*t, pos, **kw).numpy()


def _oracle(q, k, v, pos):
    return np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), pos))


@pytest.mark.parametrize("kh,h", [(2, 8), (1, 4), (4, 4)])
@pytest.mark.parametrize("pos", [0, 63, 200, 255])
def test_plain_matches_pallas_and_oracle(kh, h, pos):
    """The reference test's grid: B 2, D 16, S 256, blk 64."""
    q, k, v = _problem(pos + 10 * kh, 2, h, kh, 16, 256)
    out = _port(q, k, v, pos, blk=64)
    pal = np.asarray(ref_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            pos, blk=64, interpret=True))
    np.testing.assert_allclose(out, pal, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, _oracle(q, k, v, pos), rtol=TOL, atol=TOL)
    assert launch_counts()["flash_decode"] == 0      # CPU tensors: plain path


@pytest.mark.parametrize("blk,depth", [(32, 2), (64, 4), (128, 8)])
def test_plain_block_depth_sweep(blk, depth):
    q, k, v = _problem(blk, 2, 4, 2, 16, 256)
    out = _port(q, k, v, 170, blk=blk, depth=depth)
    pal = np.asarray(ref_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            170, blk=blk, depth=depth, interpret=True))
    np.testing.assert_allclose(out, pal, rtol=TOL, atol=TOL)
    # the recorded depth is the one the kernel would run: clamped to tiles
    assert autotune.last_choice("flash_decode") == min(depth, -(-171 // blk))


def test_plain_bf16():
    rng = np.random.RandomState(3)
    q, k, v = (jnp.asarray(rng.randn(*s), jnp.bfloat16)
               for s in ((1, 4, 32), (1, 128, 2, 32), (1, 128, 2, 32)))
    ref = np.asarray(decode_attention_ref(q, k, v, 100), np.float32)
    pal = np.asarray(ref_op(q, k, v, 100, blk=32, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (q, k, v))
    out = da.flash_decode(tq, tk, tv, 100, blk=32)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(out.float().numpy(), pal, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("s,pos", [(200, 0), (200, 150), (200, 199),
                                   (200, 250), (1056, 1040), (7, 3)])
def test_plain_cache_off_the_tile(s, pos):
    """S not a multiple of blk (the engine pads to prompt + generation),
    pos = 0, and pos past S (every key), against the oracle."""
    q, k, v = _problem(s + pos, 2, 8, 2, 16, s)
    np.testing.assert_allclose(_port(q, k, v, pos), _oracle(q, k, v, pos),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,kh,h,s,pos", [
    (2, 1, 8, 1056, 1040),    # paligemma-3b's heads: 8 on one KV head
    (2, 1, 8, 77, 0),
    (1, 2, 32, 300, 299),     # 16 query heads a KV head, the kernel's most
    (3, 1, 1, 130, 64),
])
def test_plain_head_dim_256_matches_oracle(b, kh, h, s, pos):
    """Head dim 256, which the kernel takes since paligemma-3b: the plain
    version against the reference's oracle, S off the tile."""
    q, k, v = _problem(s + pos, b, h, kh, 256, s)
    np.testing.assert_allclose(_port(q, k, v, pos), _oracle(q, k, v, pos),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,pos", [(64, 0), (64, 37), (200, 130), (40, 39)])
def test_single_decode_matches_reference(s, pos):
    """The dense engine's decode attention: the new K/V row lands at pos in
    place, then the output and both caches agree with the reference's."""
    rng = np.random.RandomState(s + pos)
    b, h, kh, d = 2, 8, 2, 16
    q = rng.randn(b, 1, h, d).astype(np.float32)
    kc = rng.randn(b, s, kh, d).astype(np.float32)
    vc = rng.randn(b, s, kh, d).astype(np.float32)
    nk = rng.randn(b, 1, kh, d).astype(np.float32)
    nv = rng.randn(b, 1, kh, d).astype(np.float32)
    ro, rk, rv = ref_common.decode_attention(
        NULL_CTX, jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(pos, jnp.int32))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for fn in (functools.partial(common.decode_attention, PORT_NULL_CTX),
               common._single_decode):
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        out, ok, ov = fn(torch.from_numpy(q), tk, tv, torch.from_numpy(nk),
                         torch.from_numpy(nv), pos)
        assert ok is tk and ov is tv                 # written in place
        np.testing.assert_allclose(out.numpy(), np.asarray(ro), rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_single_decode_without_update_reads_the_cache():
    rng = np.random.RandomState(5)
    q = rng.randn(1, 1, 4, 16).astype(np.float32)
    kc, vc = (rng.randn(1, 32, 2, 16).astype(np.float32) for _ in range(2))
    nk = np.zeros((1, 1, 2, 16), np.float32)
    ro, _, _ = ref_common._single_decode(jnp.asarray(q), jnp.asarray(kc),
                                         jnp.asarray(vc), jnp.asarray(nk),
                                         jnp.asarray(nk), 20, update=False)
    tk = torch.from_numpy(kc.copy())
    out, _, _ = common._single_decode(torch.from_numpy(q), tk,
                                      torch.from_numpy(vc.copy()),
                                      torch.from_numpy(nk),
                                      torch.from_numpy(nk), 20, update=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(tk.numpy(), kc)


def test_ops_decode_attention_is_the_wrapper():
    q, k, v = _problem(9, 1, 4, 2, 16, 64)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_array_equal(ops.decode_attention(*t, 40, blk=32).numpy(),
                                  da.flash_decode(*t, 40, blk=32).numpy())


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _problem(4, 2, 4, 2, 16, 64))
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, -1)
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, 3, depth=0)
    with pytest.raises(ValueError):
        da.flash_decode(q[:, :3], k, v, 3)                 # H % KH != 0
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v[:, :32], 3)
    with pytest.raises(ValueError):
        da.flash_decode(q[:1], k, v, 3)                    # batch mismatch
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, 3, blk=0)


@pytest.mark.parametrize("g,d,blk,itemsize,want", [
    (8, 128, 128, 2, 3),      # yi-6b bf16: 68 KiB per padded K/V tile pair
    (8, 128, 128, 4, 1),      # yi-6b f32: one 132 KiB pair
    (2, 16, 128, 4, 11),      # reduced yi-6b f32
    (8, 256, 64, 2, 3),       # paligemma-3b bf16: 66 KiB per tile pair
    (8, 256, 64, 4, 1),       # paligemma-3b f32: one 130 KiB pair
])
def test_kernel_depth_clamps_to_shared_memory(g, d, blk, itemsize, want):
    assert da.flash_kernel_depth(64, g=g, d=d, blk=blk, itemsize=itemsize,
                                 n_tiles=100) == want
    assert da._flash_smem_bytes(g, d, blk, want, itemsize) <= ring.SMEM_LIMIT
    assert da._flash_smem_bytes(g, d, blk, want + 1, itemsize) > \
        ring.SMEM_LIMIT
    assert da.flash_kernel_depth(64, g=g, d=d, blk=blk, itemsize=itemsize,
                                 n_tiles=1) == 1


def test_kernel_source_uses_the_shared_ring_and_skips_dead_rows():
    src = Path(da.FLASH_SOURCE).read_text()
    assert '#include "../../csrc/coro_ring.cuh"' in src
    assert not re.search(r"void\s+cp_async_wait_pending", src)
    assert "n_keys" in src and "pos + 1 < S ? pos + 1 : S" in src
    for d in da.FLASH_HEAD_DIMS:
        assert f"case {d}:" in src
    # the split pass and its merge; bf16 products on the tensor cores
    assert "dim3(a.B * a.KH, a.n_split)" in src and "merge_kernel" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    # every K/V row address from one device function
    assert src.count("row_of(") == 1 and "struct DenseRows" in src
    # the wrapper's warp count is the source's
    assert f"constexpr int kThreads = {32 * da.WARPS};" in src


# ---------------------------------------------------------- the split plan

H100_SMS = 132


@pytest.mark.parametrize("b,kh,s,blk,sms,splits", [
    (8, 4, 1056, 128, H100_SMS, None),     # yi-6b at batch 8: the path
    (1, 4, 1056, 128, H100_SMS, None),
    (8, 4, 1056, 64, H100_SMS, None),
    (3, 4, 1056, 128, H100_SMS, None),
    (2, 2, 77, 16, H100_SMS, None),
    (8, 4, 1056, 128, H100_SMS, 2),
    (8, 4, 1056, 128, H100_SMS, 4),
    (8, 4, 1056, 128, H100_SMS, 1000),
    (66, 4, 1056, 128, H100_SMS, None),    # B * KH = 2 * SMs
    (1, 1, 1, 128, 8, None),
])
def test_split_plan_covers_every_tile_once(b, kh, s, blk, sms, splits):
    n_split, per = da.split_plan(b, kh, s, blk, sms, splits)
    n_tiles = -(-s // blk)
    runs = [range(i * per, min((i + 1) * per, n_tiles))
            for i in range(n_split)]
    assert all(len(r) for r in runs)             # no split without a tile
    assert [t for r in runs for t in r] == list(range(n_tiles))
    if splits is not None:
        assert n_split <= splits


def test_split_plan_fills_the_card_at_the_path_shape():
    """B 8, KH 4, S 1056 in the default 64-row tiles: 17 tiles, 9 splits
    of 2, 288 blocks for 132 SMs (32 without the split)."""
    assert da.FLASH_BLK == 64
    n_split, per = da.split_plan(8, 4, 1056, da.FLASH_BLK, H100_SMS)
    assert (n_split, per) == (9, 2)
    assert 8 * 4 * n_split >= da.BLOCKS_PER_SM * H100_SMS
    assert da.split_plan(8, 4, 1056, 128, H100_SMS) == (9, 1)
    assert da.split_plan(1, 4, 1056, 64, H100_SMS) == (17, 1)   # all tiles


@pytest.mark.parametrize("b,kh", [(66, 4), (264, 1), (40, 8)])
def test_split_plan_gives_one_split_when_the_batch_fills_the_card(b, kh):
    assert b * kh >= da.BLOCKS_PER_SM * H100_SMS
    assert da.split_plan(b, kh, 1056, 128, H100_SMS) == (1, 9)


@pytest.mark.parametrize("splits,pos,want", [
    (3, 1040, 6),     # 17 tiles in 3 splits: a split's 6 tiles bound it
    (17, 1040, 1),
    (1, 1040, 8),     # one split of 17 live tiles: the depth asked for
    (1, 50, 1),       # only tile 0 is live
])
def test_depth_is_clamped_to_the_tiles_of_one_split(splits, pos, want):
    q, k, v = (torch.from_numpy(a) for a in _problem(1, 1, 4, 2, 16, 1056))
    da.flash_decode(q, k, v, pos, depth=8, splits=splits)
    assert autotune.last_choice("flash_decode") == want
    blk = da.FLASH_BLK
    n_split, per = da.split_plan(1, 2, 1056, blk, 0, splits)
    assert want == da.flash_kernel_depth(
        8, g=2, d=16, blk=blk, itemsize=4,
        n_tiles=min(per, -(-min(pos + 1, 1056) // blk)))


def _split_merge_model(q, k, v, pos, blk, n_split, per):
    """The kernel's arithmetic in torch ops: each split's f32 partial
    (m in the log2 domain, l, acc) over its live rows, an empty partial
    (-1e30, 0, 0) for a split past pos, then the merge kernel's formula."""
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    n_keys = min(pos + 1, s)
    qg = q.float().reshape(b, kh, g, d)
    scale_log2 = d ** -0.5 * 1.4426950408889634
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo, hi = i * per * blk, min(n_keys, (i + 1) * per * blk)
        if hi <= lo:
            ms.append(torch.full((b, kh, g), da.NEG_INF))
            ls.append(torch.zeros(b, kh, g))
            accs.append(torch.zeros(b, kh, g, d))
            continue
        sc = torch.einsum("bkgd,bskd->bkgs", qg, k[:, lo:hi].float())
        sc = sc * scale_log2
        m = sc.amax(dim=-1)
        p = torch.exp2(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:hi].float()))
    m_all = torch.stack(ms)                               # [n_split, b, kh, g]
    mx = m_all.amax(dim=0)
    w = torch.exp2(m_all - mx)
    l_all = (torch.stack(ls) * w).sum(dim=0)
    acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
    out = acc / l_all.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


@pytest.mark.parametrize("pos", [0, 100, 383, 384, 385, 640, 767, 768, 1040,
                                 1055, 2000])
@pytest.mark.parametrize("blk,splits", [(64, 1), (64, 2), (64, 3), (64, None),
                                        (128, 3), (128, None)])
def test_split_and_merge_equal_the_plain_version(pos, blk, splits):
    """At the path's S (1056 rows) in 64- and 128-row tiles: pos in the
    first split (the later ones empty), at split boundaries (384 = 6 tiles
    of 64, 3 of 128) and +-1, and past S, merged as the kernel merges,
    against the plain version and the reference oracle at 2e-5 in f32."""
    q, k, v = _problem(pos, 2, 8, 2, 16, 1056)
    n_split, per = da.split_plan(2, 2, 1056, blk, H100_SMS, splits)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = _split_merge_model(*t, pos, blk, n_split, per).numpy()
    np.testing.assert_allclose(got, da.flash_decode_plain(*t, pos).numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _oracle(q, k, v, pos), rtol=TOL, atol=TOL)


def test_wrapper_rejects_bad_splits():
    q, k, v = (torch.from_numpy(a) for a in _problem(4, 2, 4, 2, 16, 64))
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, 3, splits=0)
    out = da.flash_decode(q, k, v, 3, splits=5)      # the plain version
    np.testing.assert_array_equal(out.numpy(),
                                  da.flash_decode_plain(q, k, v, 3).numpy())


@pytest.mark.parametrize("profile", ["v5e", "cpu-interpret", "h100"])
@pytest.mark.parametrize("blk,kh,g,d,dtype", [
    (128, 4, 8, 128, "bfloat16"),    # yi-6b, the dense engine's decode
    (128, 8, 12, 128, "float32"),    # kernel_bench's context row
    (64, 2, 4, 16, "float32"),       # kernel_bench's --json workload
    (128, 2, 2, 16, "float32"),      # reduced yi-6b
])
def test_spec_context_and_depth_match_reference(profile, blk, kh, g, d, dtype):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    spec = da.decode_spec(blk, kh, g, d, getattr(torch, dtype))
    ref_spec = ref_da.decode_spec(blk, kh, g, d, jnp.dtype(dtype))
    for depth in (1, 2, 7):
        assert spec.context_bytes(depth) == ref_spec.context_bytes(depth)
        assert spec.context_bytes(depth, baseline=True) == \
            ref_spec.context_bytes(depth, baseline=True)
    assert spec.profile() == type(spec.profile())(
        **dataclasses.asdict(ref_spec.profile()))
    got = autotune.choose_depth(spec.profile(), machine=mm,
                                vars=spec.all_vars())
    want = ref_autotune.choose_depth(ref_spec.profile(), machine=ref_mm,
                                     vars=ref_spec.all_vars())
    assert got == want


@pytest.mark.parametrize("pos", [0, 50, 170, 255, 256, 400])
def test_plain_with_a_device_pos_matches_pallas(pos):
    """pos as a 0-d int32 tensor (the dense engine's, which the host never
    reads) against the Pallas kernel given ``jnp.asarray(pos, int32)`` and
    the oracle, at S - 1 and past S too; the recorded depth is the clamp to
    one split's tiles from S alone, as the reference's ``n_tiles`` is."""
    q, k, v = _problem(pos + 3, 2, 8, 2, 16, 256)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    dev_pos = torch.tensor(pos, dtype=torch.int32)
    out = da.flash_decode(*t, dev_pos, blk=64, depth=8).numpy()
    jpos = jnp.asarray(pos, jnp.int32)
    pal = np.asarray(ref_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jpos, blk=64, depth=8, interpret=True))
    np.testing.assert_allclose(out, pal, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, _oracle(q, k, v, jpos), rtol=TOL,
                               atol=TOL)
    _, per = da.split_plan(2, 2, 256, 64, 0, 1)
    assert autotune.last_choice("flash_decode") == da.flash_kernel_depth(
        8, g=4, d=16, blk=64, itemsize=4, n_tiles=per) == 4
    np.testing.assert_array_equal(
        da.flash_decode_plain(*t, dev_pos).numpy(), out)


def test_tensor_pos_is_checked_without_reading_it():
    q, k, v = (torch.from_numpy(a) for a in _problem(4, 2, 4, 2, 16, 64))
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(ValueError):
        da.flash_decode(q, k, v, torch.tensor(3))          # int64
    out = da.flash_decode(q, k, v, torch.tensor([30], dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(),
                                  da.flash_decode(q, k, v, 30).numpy())
