"""The port's sharding rules against the reference's, without devices.

`ShardingCtx.spec` of the port gives, for every leaf of every shipped
config's parameter tree and of its decode caches (shape suites decode_32k
and train_4k), the entries of the reference's `PartitionSpec` for the
same leaf: on the production meshes (16, 16) and (2, 16, 16) with a
`pod` axis and on an 8-way `data`-only mesh, under the training and the
serving layouts. The reference's context takes a stand-in mesh (its axis
names and device-array shape), as its own `tests/test_sharding.py` does.
Also `tree_specs`, `mesh_by_name`, `rules_for`,
`serving_config_overrides`, the local shard of a spec, and the spec trees
of `Model` and `runtime.steps`.
"""
import types

import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.models import lm as ref_lm
from repro.models import params as ref_pm
from repro.runtime import layouts as ref_layouts
from repro.sharding import ShardingCtx as RefCtx
from repro_torch.configs import REGISTRY
from repro_torch.configs.shapes import SHAPES, decode_batch_specs
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import build_model, lm
from repro_torch.models import params as pm
from repro_torch.runtime import layouts
from repro_torch.runtime.steps import (
    abstract_state,
    batch_shardings,
    state_shardings,
)
from repro_torch.sharding import NULL_CTX, Mesh, ShardingCtx, local_shard

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "data8": ((8,), ("data",))}
LAYOUTS = ["training", "serving"]
SHAPE_NAMES = ["decode_32k", "train_4k"]


@pytest.fixture(autouse=True)
def _reset_port():
    repro_torch.reset()
    yield
    repro_torch.reset()


def _ctxs(mesh, layout):
    shape, names = MESHES[mesh]
    fake = types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))
    return (RefCtx(mesh=fake, rules=ref_layouts.rules_for(layout)),
            ShardingCtx(mesh=Mesh(names, shape),
                        rules=layouts.rules_for(layout)))


def _ref_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _ref_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _port_leaves(tree, prefix=()):
    if pm.is_spec(tree):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _port_leaves(v, prefix + (k,))


def _same_specs(ref_tree, port_tree, ref_ctx, ctx):
    ref = dict(_ref_leaves(ref_tree))
    port = dict(_port_leaves(port_tree))
    assert ref.keys() == port.keys()
    for path, want in ref.items():
        got = port[path]
        assert tuple(got.shape) == tuple(want.shape) and got.axes == want.axes
        assert ctx.spec(got.axes, got.shape) == \
            tuple(ref_ctx.spec(want.axes, want.shape)), path


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_specs_match_reference(arch, mesh, layout):
    ref_ctx, ctx = _ctxs(mesh, layout)
    _same_specs(ref_lm.param_specs(REF_REGISTRY[arch]),
                lm.param_specs(REGISTRY[arch]), ref_ctx, ctx)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_specs_match_reference(arch, mesh, layout, shape):
    ref_ctx, ctx = _ctxs(mesh, layout)
    _same_specs(ref_lm.cache_specs(REF_REGISTRY[arch], REF_SHAPES[shape]),
                lm.cache_specs(REGISTRY[arch], SHAPES[shape]), ref_ctx, ctx)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_partition_spec_trees_match_reference(mesh):
    ref_ctx, ctx = _ctxs(mesh, "training")
    for arch in ("granite-moe-1b-a400m", "whisper-medium"):
        want = ref_pm.partition_specs(ref_lm.param_specs(REF_REGISTRY[arch]),
                                      ref_ctx)
        got = build_model(REGISTRY[arch], ctx).param_partition_specs()
        assert {p: tuple(s) for p, s in _ref_leaves(want)} == \
            dict(_ref_leaves(got))


def test_guards_and_rules_as_in_the_reference():
    _, ctx = _ctxs("16x16", "training")
    _, ctx3 = _ctxs("pod2x16x16", "training")
    assert ctx3.spec(("batch", "seq", None), (256, 4096, 1)) == \
        (("pod", "data"),)
    assert ctx.spec(("batch", "kv_heads"), (256, 1)) == ("data",)
    assert ctx.spec(("vocab", "embed"), (49155, 2048)) == (None, "data")
    assert ctx.spec(("experts", "embed", "mlp"), (128, 2048, 768)) == \
        ("model", "data")
    assert NULL_CTX.spec(("batch",), (8,)) == ()
    assert ctx.constrain("x", ("batch",)) == "x"


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tree_specs_match_reference(mesh):
    from repro.sharding import tree_specs as ref_tree_specs
    from repro_torch.sharding import tree_specs

    ref_ctx, ctx = _ctxs(mesh, "training")
    axes = {"tokens": ("batch", None), "head": {"w": ("vocab", "embed")},
            "pos": ()}
    shapes = {"tokens": (256, 4096), "head": {"w": (49155, 2048)},
              "pos": ()}
    want = ref_tree_specs(ref_ctx, axes, shapes)
    got = tree_specs(ctx, axes, shapes)
    assert got == {"tokens": tuple(want["tokens"]),
                   "head": {"w": tuple(want["head"]["w"])},
                   "pos": tuple(want["pos"])}


def test_mesh_shapes_and_layouts():
    assert port_mesh.make_production_mesh() == Mesh(("data", "model"),
                                                    (16, 16))
    assert port_mesh.make_production_mesh(multi_pod=True).shape == (2, 16, 16)
    assert port_mesh.mesh_by_name("mini", devices=4).shape == (2, 2)
    assert port_mesh.mesh_by_name("mini", devices=3).shape == (3, 1)
    assert port_mesh.mesh_by_name("mini").shape == (1, 1)   # one process
    assert port_mesh.mesh_by_name("single").shape == (16, 16)
    assert port_mesh.parse_mesh("1x2") == (1, 2)
    with pytest.raises(ValueError):
        port_mesh.mesh_by_name("huge")
    with pytest.raises(ValueError):
        port_mesh.parse_mesh("2")
    for name in ("training", "default", "serving"):
        assert layouts.rules_for(name) == ref_layouts.rules_for(name)
    with pytest.raises(ValueError):
        layouts.rules_for("inference")
    assert layouts.serving_config_overrides() == \
        ref_layouts.serving_config_overrides() == \
        {"param_dtype": "bfloat16", "cache_update": "row"}
    from repro_torch.launch.serve import SERVING_OVERRIDES
    assert SERVING_OVERRIDES == layouts.serving_config_overrides()


def test_local_shard_takes_this_ranks_block():
    x = torch.arange(4 * 6).reshape(4, 6)
    mesh = Mesh(("data", "model"), (2, 3), device_mesh=object(),
                coordinate=(1, 2))
    ctx = ShardingCtx(mesh=mesh)
    assert torch.equal(local_shard(x, ("data", "model"), ctx), x[2:, 4:])
    assert torch.equal(local_shard(x, (None, "model"), ctx), x[:, 4:])
    assert local_shard(x, (), ctx) is x
    flat = torch.arange(12)
    assert torch.equal(local_shard(flat, (("data", "model"),), ctx),
                       flat[10:12])   # row-major over (data, model): 1*3+2


def test_held_params_split_only_the_experts():
    cfg = REGISTRY["granite-moe-1b-a400m"]
    ctx = ShardingCtx(mesh=Mesh(("data", "model"), (2, 2)))
    held = dict(_ref_leaves(pm.held_specs(lm.param_specs(cfg), cfg, ctx)))
    split = {p: s for p, s in held.items() if s}
    assert split == {("layers", "moe", k): (None, "model")
                     for k in ("w_gate", "w_up", "w_down")}
    dense = pm.held_specs(lm.param_specs(cfg), cfg.replace(moe_impl="dense"),
                          ctx)
    assert not any(s for _, s in _ref_leaves(dense))


def test_step_spec_trees_and_meta_state():
    cfg = REGISTRY["yi-6b"]
    assert batch_shardings(NULL_CTX, {}) is None
    assert state_shardings(build_model(cfg)) is None
    _, ctx = _ctxs("16x16", "serving")
    specs = batch_shardings(ctx, decode_batch_specs(cfg, SHAPES["decode_32k"]))
    assert specs == {"tokens": ("data",), "positions": ("data",)}
    model = build_model(cfg, ctx)
    st = state_shardings(model)
    assert st["step"] == () and st["mu"] == st["params"]
    state = abstract_state(model)
    assert state["step"].device.type == "meta"
    assert all(t.device.type == "meta"
               for _, t in _ref_leaves(state["params"]))
    cache = model.abstract_cache(SHAPES["decode_32k"])
    assert tuple(cache["layers"]["k"].shape) == (32, 128, 32768, 4, 128)
    assert model.cache_partition_specs(SHAPES["decode_32k"])["layers"]["k"] \
        == (None, "data", "model")
