"""The port's roofline accounting (`repro_torch/roofline.py`) against the
reference's (`repro/roofline.py`), the traced step's counts
(`StepCounter`) on small steps, and every kernel wrapper's meta route
(`kernels.ring.meta_call`) against a CPU run of its plain version.

`model_flops` is analytic and must return the reference's numbers exactly
for every arch x shape x kind; `terms` and `dominant` too under a profile
both packages share (``v5e``). The reference has no ``h100`` profile, so
under it the port's terms are held to their formula.
"""
import pytest
import torch

import repro_torch
from repro import roofline as ref_roofline
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_supported as ref_cell_supported
from repro.configs import get_config as ref_get_config
from repro.core import machine as ref_machine
from repro_torch import roofline
from repro_torch.configs import ALL_ARCH_NAMES, get_config
from repro_torch.configs.shapes import ALL_SHAPE_NAMES, SHAPES, cell_supported
from repro_torch.core import machine
from repro_torch.kernels import launch_counts, ring
from repro_torch.kernels.coro_gather import coro_gather as cg
from repro_torch.kernels.coro_scatter_add import coro_scatter_add as sa
from repro_torch.kernels.decode_attention import decode_attention as da
from repro_torch.kernels.moe_gmm import moe_gmm as mg
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.ssd_scan import ssd_scan as ss
from repro_torch.kernels.stream_copy import stream_copy as sc

CELLS = [(a, s) for a in ALL_ARCH_NAMES for s in ALL_SHAPE_NAMES]


@pytest.fixture(autouse=True)
def _reset_port():
    torch.set_num_threads(1)
    repro_torch.reset()
    yield
    repro_torch.reset()
    ref_machine.set_machine(None)


# ------------------------------------------------------- the analytic side


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_references(arch, shape, kind):
    assert roofline.model_flops(get_config(arch), SHAPES[shape], kind) == \
        ref_roofline.model_flops(ref_get_config(arch), REF_SHAPES[shape],
                                 kind)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_supported_as_the_reference(arch, shape):
    assert cell_supported(get_config(arch), SHAPES[shape]) == \
        ref_cell_supported(ref_get_config(arch), REF_SHAPES[shape])


def _term_inputs(arch, shape):
    """Per-chip counts of the size a cell has: its model FLOPs over 256
    chips, bytes and collectives scaled from them."""
    f = roofline.model_flops(get_config(arch), SHAPES[shape],
                             SHAPES[shape].kind) / 256
    return f, f / 37.0, {"all-reduce": int(f / 4e3), "all-to-all":
                         int(f / 9e3), "all-gather": int(f / 2e5)}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_terms_and_dominant_equal_the_references_under_v5e(arch, shape):
    machine.set_machine("v5e")
    ref_machine.set_machine("v5e")
    flops, nbytes, coll = _term_inputs(arch, shape)
    t = roofline.terms(flops, nbytes, coll)
    assert t == ref_roofline.terms(flops, nbytes, coll)
    assert roofline.dominant(t) == ref_roofline.dominant(t)
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        assert getattr(roofline, name) == getattr(ref_roofline, name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_terms_under_h100_are_the_formula(arch, shape):
    m = machine.set_machine("h100")
    flops, nbytes, coll = _term_inputs(arch, shape)
    t = roofline.terms(flops, nbytes, coll)
    assert t == {"compute_s": flops / 989e12, "memory_s": nbytes / 3.35e12,
                 "collective_s": sum(coll.values()) / 450e9}
    assert (m.peak_flops, m.hbm_bw, m.ici_bw) == (989e12, 3.35e12, 450e9)
    assert roofline.dominant(t) == max(t, key=t.get)
    assert roofline.PEAK_FLOPS == 989e12


# --------------------------------------------------------- the step counter


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn, *args):
    with roofline.StepCounter(args) as counter:
        out = fn(*args)
    counter.finish(out)
    return counter, out


def test_matmul_flops_and_bytes():
    a, b = _meta(64, 32), _meta(32, 16)
    c, _ = _count(torch.mm, a, b)
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert c.memory == {"argument_size_in_bytes": (64 * 32 + 32 * 16) * 4,
                        "output_size_in_bytes": 64 * 16 * 4,
                        "temp_size_in_bytes": 0}


def test_views_count_nothing_and_in_place_counts_its_operand_once():
    x = _meta(8, 16)

    def step(x):
        v = x.t().reshape(16, 8)[2:]      # views only
        x.add_(1.0)                      # reads and writes x: counted once
        return v

    c, _ = _count(step, x)
    assert c.flops == 0
    assert c.bytes == 8 * 16 * 4
    assert c.memory["temp_size_in_bytes"] == 0


def test_temp_is_the_peak_of_live_intermediates_by_storage():
    x = _meta(1024)

    def step(x):
        a = x * 2                      # 4 KiB live
        b = a[::2]                     # a view of a: adds nothing
        c = a + 1                      # 8 KiB live at the peak
        del a, b
        return c.sum()

    c, _ = _count(step, x)
    assert c.memory["temp_size_in_bytes"] == 2 * 4096
    assert c.memory["argument_size_in_bytes"] == 4096
    assert c.memory["output_size_in_bytes"] == 4


def test_an_argument_never_read_is_not_counted():
    used, unused = _meta(10), _meta(1000)
    c, _ = _count(lambda u, _: u + 1, used, unused)
    assert c.memory["argument_size_in_bytes"] == 40


def test_backward_is_counted():
    w = _meta(32, 32).requires_grad_(True)
    x = _meta(8, 32)

    def step(w, x):
        return torch.autograd.grad((x @ w).sum(), w)[0]

    c, _ = _count(step, w, x)
    assert c.flops == 2 * (2 * 8 * 32 * 32)      # forward and d w


# ------------------------------------------------- the kernels' meta routes


def _cases():
    """(name, wrapper, CPU operands, kwargs, the cost it must record)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    table = r(64, 8)
    idx = torch.randperm(64, generator=g)[:16].to(torch.int32)
    starts = torch.tensor([0, 9, 30, 50], dtype=torch.int32)
    upd = r(16, 8)
    q, kc, vc = r(2, 4, 16), r(2, 40, 2, 16), r(2, 40, 2, 16)
    pool_k, pool_v = r(9, 8, 2, 16), r(9, 8, 2, 16)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    lengths = torch.tensor([11, 30], dtype=torch.int32)
    tokens, weights = r(3, 5, 16), r(3, 16, 8)
    x, dt, A, B, C = (r(1, 64, 2, 8), r(1, 64, 2).abs(), -r(2).abs(),
                      r(1, 64, 8), r(1, 64, 8))
    dy = r(1, 64, 2, 8)
    return [
        ("row_gather", cg.row_gather, (table, idx), {},
         cg.row_gather_cost(16, 32)),
        ("span_gather", cg.span_gather, (table, starts), {"span": 8},
         cg.span_gather_cost(4, 8, 32)),
        ("scatter_add", sa.scatter_add_unique, (table, idx, upd), {},
         sa.scatter_add_cost(16, 8, 4)),
        ("stream_triad", sc.triad, (r(128, 8), r(128, 8), 3.0), {},
         sc.triad_cost(128 * 8, 4)),
        ("flash_decode", da.flash_decode, (q, kc, vc, 25), {},
         da.flash_decode_cost(2, 4, 2, 16, 26, 4)),
        ("flash_decode", da.flash_decode, (q, kc, vc, 25),
         {"return_lse": True}, da.flash_decode_cost(2, 4, 2, 16, 26, 4,
                                                    lse=True)),
        ("paged_decode", da.paged_flash_decode,
         (q, pool_k, pool_v, bt, lengths), {},
         da.paged_decode_cost(2, 4, 2, 16, 4, 2 * 4 * 8, 4)),
        ("moe_gmm", mg.gmm, (tokens, weights), {},
         mg.cost(3, 5, 16, 8, 4, False)),
        ("moe_gmm", mg.gmm, (tokens[:1].expand(3, 5, 16), weights), {},
         mg.cost(3, 5, 16, 8, 4, True)),
        ("ssd_scan", ss.ssd_scan, (x, dt, A, B, C), {"chunk": 16},
         ss.cost(1, 64, 2, 8, 8, 16, 4)),
        ("ssd_scan_bwd", ss.ssd_scan_bwd, (x, dt, A, B, C, dy), {"chunk": 16},
         ss.bwd_cost(1, 64, 2, 8, 8, 4)),
    ]


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        if x.stride(0) == 0:                    # keep a stride-0 expansion
            return torch.empty(x.shape[1:], dtype=x.dtype,
                               device="meta").expand(x.shape)
        return torch.empty_like(x, device="meta")
    return x


def _shapes(out):
    if isinstance(out, torch.Tensor):
        return [(tuple(out.shape), out.dtype)]
    return [s for o in out for s in _shapes(o)]


@pytest.mark.parametrize("case", range(len(_cases())))
def test_meta_route_returns_the_plain_shapes_and_records_the_cost(case):
    name, fn, args, kw, cost = _cases()[case]
    want = fn(*args, **kw)                      # CPU: the plain version
    margs = tuple(_to_meta(a) for a in args)
    with roofline.StepCounter(margs) as counter:
        got = fn(*margs, **kw)
    assert _shapes(got) == _shapes(want)
    assert all(t.device.type == "meta" for t in
               ([got] if isinstance(got, torch.Tensor) else got))
    assert counter.kernels == {name: {"calls": 1, "flops": float(cost[0]),
                                      "bytes": float(cost[1])}}
    assert counter.flops == cost[0] and counter.bytes == cost[1]
    assert not any(launch_counts().values())


@pytest.mark.parametrize("case", range(len(_cases())))
def test_meta_beside_cpu_raises(case):
    _, fn, args, kw, _ = _cases()[case]
    mixed = (_to_meta(args[0]),) + args[1:]
    with pytest.raises(ValueError):
        fn(*mixed, **kw)


def test_route_answers_by_device():
    cpu, meta = torch.zeros(4), torch.zeros(4, device="meta")
    assert ring.route("k", ("a", cpu), ("b", cpu)) == "cpu"
    assert ring.route("k", ("a", meta), ("b", meta)) == "meta"
    with pytest.raises(ValueError, match="is on"):
        ring.route("k", ("a", meta), ("b", cpu))


def test_meta_route_outside_a_counter_records_nothing():
    out = mg.gmm(_meta(2, 3, 8), _meta(2, 8, 4))
    assert out.shape == (2, 3, 4) and out.device.type == "meta"


def test_differentiable_kernels_trace_their_backward():
    """`moe_gmm`'s backward is two more K2 calls on meta tensors."""
    t = _meta(1, 6, 8).requires_grad_(True)
    w = _meta(3, 8, 4).requires_grad_(True)

    def step(t, w):
        return torch.autograd.grad(moe_gmm(t, w).sum(), (t, w))

    c, (dt_, dw) = _count(step, t, w)
    assert c.kernels["moe_gmm"]["calls"] == 3
    assert dt_.shape == t.shape and dw.shape == w.shape
