"""The port's MoE layer and grouped matmul against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages. The port's
`gmm` on CPU tensors (its plain version) is held to the reference's Pallas
kernel in interpret mode and to its einsum oracle at 1e-4, the tolerance of
the reference's own kernel test; the router, the expert FFN and the dense
MoE layer agree in f32 (router 1e-6, the rest 1e-4 or the reference's f32
parity bound 2e-3). The kernel's CoroSpec gives the reference's solved
depth under one shared MachineModel. The CUDA kernel itself is checked
against the plain version on the card (`test_torch_kernels_cuda.py`).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.core import autotune as ref_autotune
from repro.core import machine as ref_machine
from repro.kernels.moe_gmm.moe_gmm import gmm_spec as ref_gmm_spec
from repro.kernels.moe_gmm.ops import moe_gmm as ref_moe_gmm
from repro.kernels.moe_gmm.ref import gmm_ref
from repro.models import moe as ref_moe
from repro.models import params as ref_pm
from repro_torch.configs import get_config
from repro_torch.core import autotune, machine
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.moe_gmm import moe_gmm as mg
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models import moe

GMM_TOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")
MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True)
def _reset_port():
    # tiny tensors: one intra-op thread, leaving the cores to other workers
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _moe_params(arch, seed):
    """The reference's seeded MoE parameters of a reduced f32 arch, as
    numpy and as the port's tensors."""
    ref_cfg = ref_get_config(arch).reduced().replace(**F32)
    cfg = get_config(arch).reduced().replace(**F32)
    ref_p = ref_pm.initialize(jax.random.PRNGKey(seed),
                              ref_moe.moe_param_specs(ref_cfg))
    tree = {k: np.asarray(v) for k, v in ref_p.items()}
    return ref_cfg, cfg, ref_p, {k: _t(v) for k, v in tree.items()}


@pytest.mark.parametrize("e,c,dm,f,ft", [(2, 8, 16, 128, 128),
                                         (4, 16, 32, 256, 128)])
def test_gmm_matches_reference_kernel(e, c, dm, f, ft):
    """The reference test's shapes: port gmm (CPU) and gmm_plain against
    the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(0)
    t = rng.randn(e, c, dm).astype(np.float32)
    w = rng.randn(e, dm, f).astype(np.float32)
    want = np.asarray(ref_moe_gmm(jnp.asarray(t), jnp.asarray(w), f_tile=ft))
    got = moe_gmm(_t(t), _t(w), f_tile=ft)
    assert got.dtype == torch.float32 and got.shape == (e, c, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=GMM_TOL, atol=GMM_TOL)
    np.testing.assert_allclose(mg.gmm_plain(_t(t), _t(w)).numpy(), want,
                               rtol=GMM_TOL, atol=GMM_TOL)
    assert launch_counts()["moe_gmm"] == 0          # CPU: the plain version


@pytest.mark.parametrize("e,c,dm,f", [(3, 1, 64, 32), (3, 5, 64, 32),
                                      (2, 33, 48, 40), (4, 5, 96, 200)])
@pytest.mark.parametrize("shared", [False, True])
def test_gmm_tails_and_shared_tokens_match_reference_oracle(e, c, dm, f,
                                                            shared):
    """Ragged C, dm and f (off every tile), and one token block shared by
    every expert as a stride-0 view, against the reference's einsum."""
    rng = np.random.RandomState(1)
    w = rng.randn(e, dm, f).astype(np.float32)
    if shared:
        block = rng.randn(1, c, dm).astype(np.float32)
        t = np.broadcast_to(block, (e, c, dm))
        tokens = _t(block).expand(e, c, dm)
        assert tokens.stride(0) == 0
    else:
        t = rng.randn(e, c, dm).astype(np.float32)
        tokens = _t(t)
    want = np.asarray(gmm_ref(jnp.asarray(t), jnp.asarray(w)))
    got = mg.gmm(tokens, _t(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=GMM_TOL, atol=GMM_TOL)


def test_gmm_keeps_the_token_type_and_rejects_bad_inputs():
    rng = np.random.RandomState(2)
    t = _t(rng.randn(2, 3, 16).astype(np.float32)).bfloat16()
    w = _t(rng.randn(2, 16, 8).astype(np.float32)).bfloat16()
    out = mg.gmm(t, w)
    assert out.dtype == torch.bfloat16
    want = torch.einsum("ecd,edf->ecf", t.float(), w.float()).bfloat16()
    assert torch.equal(out, want)                   # f32 sum, one rounding
    with pytest.raises(ValueError):
        mg.gmm(t, w[:1])                            # expert count differs
    with pytest.raises(ValueError):
        mg.gmm(t, w[:, :8])                         # dm differs
    with pytest.raises(ValueError):
        mg.gmm(t[0], w)                             # not [E, C, dm]
    with pytest.raises(ValueError):
        mg.gmm(t, w, depth=0)


def test_router_topk_matches_reference():
    ref_cfg, cfg, ref_p, p = _moe_params("qwen3-moe-30b-a3b", 0)
    x = np.random.RandomState(3).randn(32, cfg.d_model).astype(np.float32)
    want = ref_moe.router_topk(jnp.asarray(x), ref_p["router"], ref_cfg.top_k)
    gates, experts, aux = moe.router_topk(_t(x), p["router"], cfg.top_k)
    assert experts.dtype == torch.int32 and gates.dtype == torch.float32
    np.testing.assert_array_equal(experts.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want[2]), rtol=1e-6,
                               atol=1e-6)


def test_expert_ffn_matches_reference_gmm_path():
    """The reference's streamed-weight path (Pallas, interpret mode)."""
    rng = np.random.RandomState(4)
    e, c, dm, f = 2, 8, 128, 256
    xs = rng.randn(e, c, dm).astype(np.float32)
    wg, wu = (rng.randn(e, dm, f).astype(np.float32) * 0.1 for _ in range(2))
    wd = rng.randn(e, f, dm).astype(np.float32) * 0.1
    want = ref_moe._expert_ffn(*map(jnp.asarray, (xs, wg, wu, wd)),
                               use_gmm=True)
    got = moe._expert_ffn(*map(_t, (xs, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GMM_TOL,
                               atol=GMM_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("lead", ["experts", "broadcast"])
def test_expert_ffn_matches_reference_einsum_at_reduced_shapes(arch, lead):
    """Reduced widths (d_ff_expert 32, off the 128 tile), with [E, C, d]
    tokens and with the [1, T, d] block the dense layer passes."""
    ref_cfg, cfg, ref_p, p = _moe_params(arch, 1)
    rng = np.random.RandomState(5)
    n = cfg.n_experts if lead == "experts" else 1
    xs = rng.randn(n, 6, cfg.d_model).astype(np.float32)
    want = ref_moe._expert_ffn(jnp.asarray(xs), ref_p["w_gate"],
                               ref_p["w_up"], ref_p["w_down"], use_gmm=False)
    got = moe._expert_ffn(_t(xs), p["w_gate"], p["w_up"], p["w_down"])
    assert got.shape == (cfg.n_experts, 6, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GMM_TOL,
                               atol=GMM_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_matches_reference(arch):
    ref_cfg, cfg, ref_p, p = _moe_params(arch, 2)
    x = np.random.RandomState(6).randn(2, 7, cfg.d_model).astype(np.float32)
    want_y, want_aux = ref_moe.moe_dense(ref_p, jnp.asarray(x), ref_cfg)
    y, aux = moe.moe_dense(p, _t(x), cfg)
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("impl", ["auto", "dense", "ep"])
def test_moe_layer_without_a_mesh_is_dense(impl):
    """No mesh: every moe_impl runs the dense backend, as in the
    reference."""
    _, cfg, _, p = _moe_params("granite-moe-1b-a400m", 3)
    cfg = cfg.replace(moe_impl=impl)
    x = _t(np.random.RandomState(7).randn(1, 5, cfg.d_model)
           .astype(np.float32))
    y, aux = moe.moe_layer(p, x, cfg)
    want_y, want_aux = moe.moe_dense(p, x, cfg)
    assert torch.equal(y, want_y) and torch.equal(aux, want_aux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_specs_match_reference(arch):
    for reduce in (False, True):
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        if reduce:
            ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
        ours = moe.moe_param_specs(cfg)
        ref = ref_moe.moe_param_specs(ref_cfg)
        assert set(ours) == set(ref)
        for k, s in ours.items():
            assert (s.shape, s.axes, s.init) == \
                (ref[k].shape, ref[k].axes, ref[k].init), k


@pytest.mark.parametrize("profile", ["h100", "v5e", "cpu-interpret"])
@pytest.mark.parametrize("c,dm,f_total,dtype", [
    (5, 2048, 768, "bfloat16"),      # qwen3-moe decode round, gate / up
    (5, 768, 2048, "bfloat16"),      # ... down projection
    (32, 2048, 768, "bfloat16"),     # ... a prefill chunk
    (5, 1024, 512, "bfloat16"),      # granite-moe decode
    (16, 64, 256, "float32"),        # kernel_bench --json workload
    (64, 512, 2048, "float32"),      # kernel_bench context row
    (6, 64, 32, "float32"),          # reduced configs
])
def test_spec_context_and_depth_match_reference(profile, c, dm, f_total,
                                                dtype):
    mm = machine.machine_profile(profile)
    ref_mm = ref_machine.MachineModel(**dataclasses.asdict(mm))
    spec = mg.gmm_spec(c, dm, 128, getattr(torch, dtype), f_total=f_total)
    ref_spec = ref_gmm_spec(c, dm, 128, jnp.dtype(dtype), f_total=f_total)
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


def test_qwen3_tile_exceeds_a_block_and_solves_to_the_floor():
    """One reference tile of qwen3-moe ([2048, 128] bf16, 512 KiB) is over
    a block's shared memory: the solve falls to its floor of 2, and the
    kernel runs 2 of its [64, 128] k-slices in flight."""
    spec = mg.gmm_spec(5, 2048, 128, torch.bfloat16, f_total=768)
    assert spec.tile_bytes() > ring.SMEM_LIMIT
    machine.set_machine("h100")
    assert autotune.choose_depth(spec.profile(), vars=spec.all_vars()) == 2
    tokens = torch.zeros(128, 5, 2048, dtype=torch.bfloat16)
    mg.gmm(tokens[:2], torch.zeros(2, 2048, 128, dtype=torch.bfloat16))
    assert autotune.last_choice("moe_gmm") == 2


@pytest.mark.parametrize("depth", [1, 2, 9, 40, 500])
@pytest.mark.parametrize("c,dm,itemsize", [(5, 2048, 2), (32, 2048, 2),
                                           (5, 768, 4), (1, 64, 4)])
def test_kernel_depth_clamps_to_shared_memory_slices_and_max(depth, c, dm,
                                                             itemsize):
    got = mg.kernel_depth(depth, c=c, dm=dm, itemsize=itemsize)
    fit = ring.SMEM_LIMIT // mg.slot_bytes(c, itemsize)
    assert got == max(1, min(depth, ring.MAX_DEPTH, fit,
                             mg.n_slices(dm, itemsize)))
    assert got * mg.slot_bytes(c, itemsize) <= ring.SMEM_LIMIT
    assert 1 <= got <= ring.MAX_DEPTH


def test_slot_bytes_follow_the_kernel_source():
    """The ring geometry the host clamps with is the one the .cu lays out:
    [BK, 128] weights (swizzled TMA boxes, no pad) and [16 MT, BK + pad]
    tokens (16-byte pads) rounded up to 1024 bytes, a full and an empty
    mbarrier of 8 bytes each per slot, and 1024 bytes a block to align."""
    src = Path(mg.SOURCE).read_text()
    assert '#include "../../csrc/coro_ring.cuh"' in src
    assert "constexpr int kBN = 128;" in src and mg.F_TILE == 128
    assert "constexpr int kBarrierBytes = 16;" in src
    assert "constexpr int kAlignSlack = 1024;" in src and mg.ALIGN_SLACK == 1024
    assert mg.slot_bytes(5, 2) == 19 * 1024 + 16       # 16384 + 16 * 72 * 2
    assert mg.slot_bytes(32, 2) == 21 * 1024 + 16      # 16384 + 32 * 72 * 2
    assert mg.slot_bytes(5, 4) == 19 * 1024 + 16       # 16384 + 16 * 36 * 4
    assert mg.n_slices(2048, 2) == 32 and mg.n_slices(768, 4) == 24
    assert mg.n_slices(65, 2) == 2


# The persistent walk (moe_gmm.walk) and an emulation of the kernel's
# arithmetic along it. On the card the kernel walks exactly these tiles.
WALK_SHAPES = [  # E, C, dm, f, itemsize
    (128, 5, 2048, 768, 2),          # qwen3-moe decode, gate / up
    (128, 5, 768, 2048, 2),          # ... down
    (128, 32, 2048, 768, 2),         # ... prefill chunk, gate / up
    (128, 32, 768, 2048, 2),         # ... prefill chunk, down
    (32, 5, 1024, 512, 2),           # granite-moe decode
    (1, 5, 2048, 128, 2),            # one expert, one tile
    (3, 5, 200, 136, 4),             # ragged f and dm, f32
    (2, 33, 64, 32, 4),              # two token tiles
]


@pytest.mark.parametrize("e,c,dm,f,itemsize", WALK_SHAPES)
@pytest.mark.parametrize("blocks", [1, 2, 3, 7, 132 * 3, 132 * 5, 10 ** 6])
def test_walk_covers_every_slice_once(e, c, dm, f, itemsize, blocks):
    """Every (expert, column tile, token tile, k-slice) exactly once: each
    output tile walked whole by one block, in shares of tiles differing by
    at most one, dealt in turn so that blocks in flight together read
    neighbouring tiles."""
    w = mg.walk(e, c, dm, f, itemsize, blocks)
    n_tok = -(-c // (16 if c <= 16 else 32))
    assert w.tiles == e * -(-f // 128) * n_tok
    assert w.per_tile == mg.n_slices(dm, itemsize)
    assert w.slices == w.tiles * w.per_tile
    assert w.blocks == min(blocks, w.tiles)
    walked = [t for b in range(w.blocks) for t in w.tiles_of(b)]
    assert sorted(walked) == list(range(w.tiles))     # each tile once
    shares = {len(w.tiles_of(b)) for b in range(w.blocks)}
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    assert [w.tiles_of(b)[0] for b in range(w.blocks)] == list(range(w.blocks))


def _emulate_walk(tokens, weights, blocks):
    """The kernel's arithmetic on the CPU: each block sums the k-slices of
    every tile it walks in order, in f32, and stores the tile."""
    e, c, dm = tokens.shape
    f = weights.shape[2]
    itemsize = tokens.element_size()
    w = mg.walk(e, c, dm, f, itemsize, blocks)
    bk, bm = 128 // itemsize, 16 * (1 if c <= 16 else 2)
    out = torch.full((e, c, f), float("nan"))
    for b in range(w.blocks):
        for tile in w.tiles_of(b):
            tt = tile % w.n_tok
            col = (tile // w.n_tok) % w.n_col
            x, m0, n0 = tile // (w.n_tok * w.n_col), tt * bm, col * mg.F_TILE
            acc = torch.zeros(min(bm, c - m0), min(mg.F_TILE, f - n0))
            for k in range(w.per_tile):
                k_lo, k_hi = k * bk, min(dm, (k + 1) * bk)
                acc = acc + tokens[x, m0:m0 + bm, k_lo:k_hi].float() @ \
                    weights[x, k_lo:k_hi, n0:n0 + mg.F_TILE].float()
            out[x, m0:m0 + bm, n0:n0 + mg.F_TILE] = acc
    return out.to(tokens.dtype)


@pytest.mark.parametrize("tiles,capacity,want", [
    (768, 660, 384),                 # qwen3-moe gate/up at 5 blocks an SM
    (2048, 660, 512),                # ... down
    (768, 528, 384),                 # ... prefill, 4 an SM
    (2048, 528, 512),
    (128, 660, 128),                 # granite-moe: one tile a block
    (769, 660, 385),                 # 2 tiles a block, one block 1
    (2 * 655, 660, 655),             # two tiles a block, 5 blocks short
])
def test_grid_is_whole_tiles_a_block_where_it_fills_the_card(tiles, capacity,
                                                             want):
    """The fewest blocks that walk `tiles` in the fewest tiles a block the
    card's `capacity` allows: ceil(tiles / capacity) for the busiest."""
    got = mg.grid_blocks(tiles, capacity)
    assert got == want and got <= capacity
    most = -(-tiles // capacity)
    w = mg.walk(tiles, 5, 2048, 128, 2, got)         # one tile per expert
    assert max(len(w.tiles_of(b)) for b in range(w.blocks)) == most
    assert got == 1 or -(-tiles // (got - 1)) > most  # no fewer blocks do


@pytest.mark.parametrize("e,c,dm,f,blocks", [
    (4, 8, 256, 256, 4),             # two tiles a block
    (2, 8, 256, 256, 3),             # the reference test's f tile: 8 slices
    (2, 8, 256, 256, 5),             # one block per tile
    (1, 5, 512, 128, 7),             # one expert, one tile
    (3, 5, 200, 136, 4),             # ragged dm and f
    (2, 33, 96, 128, 100),           # two token tiles, more blocks than tiles
])
def test_walk_emulation_matches_plain_and_reference(e, c, dm, f, blocks):
    """The walk's arithmetic, emulated on the CPU, gives `gmm_plain`'s and
    the reference's results within GMM_TOL (the Pallas kernel in interpret
    mode where f is a whole number of tiles, else its einsum oracle), and
    writes every output element."""
    rng = np.random.RandomState(e * 100 + c)
    t = rng.randn(e, c, dm).astype(np.float32)
    w = rng.randn(e, dm, f).astype(np.float32)
    got = _emulate_walk(_t(t), _t(w), blocks)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), mg.gmm_plain(_t(t), _t(w)).numpy(),
                               rtol=GMM_TOL, atol=GMM_TOL)
    if f % 128 == 0:
        want = ref_moe_gmm(jnp.asarray(t), jnp.asarray(w), f_tile=128)
    else:
        want = gmm_ref(jnp.asarray(t), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GMM_TOL,
                               atol=GMM_TOL)


def test_walk_rejects_empty_work():
    with pytest.raises(ValueError):
        mg.walk(2, 5, 64, 32, 2, 0)
    assert mg.walk(2, 5, 0, 32, 2, 8).per_tile == 1   # dm = 0: one zero slice
