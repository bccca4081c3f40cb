"""Model facade: bind an ArchConfig and a `sharding.ShardingCtx` to the LM's
functions (the training loss, the dense engine's prefill and decode step,
the paged engine's steps) and to its parameter and cache spec trees."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.models import lm
from repro_torch.models import params as pm
from repro_torch.sharding import NULL_CTX, ShardingCtx


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    ctx: ShardingCtx = NULL_CTX

    # ------------------------------------------------------------- params
    def param_specs(self):
        return lm.param_specs(self.cfg)

    def abstract_params(self):
        """Meta tensors of every parameter (no memory)."""
        return pm.abstract(self.param_specs())

    def init(self, generator: torch.Generator, device, *,
             placed: bool = False):
        """Random parameters on `device`, drawn from `generator` (which
        must live on that device); on a mesh, this rank's shard of them
        (`params.local_params`: each leaf drawn whole, so every rank draws
        the same numbers), or with `placed` its blocks placed by their
        rules (`place` of the same draw, cut slice by slice as drawn)."""
        if placed:
            return pm.initialize(self.param_specs(), generator, device,
                                 ctx=self.ctx)
        params = pm.initialize(self.param_specs(), generator, device)
        if self.ctx.mesh is None:
            return params
        return pm.local_params(params, self.cfg, self.ctx)

    def param_shardings(self):
        """Every parameter's partition spec by its rules on a mesh (the
        placed layout: `place`, `runtime.steps.jit_decode_step`), None
        without one."""
        return pm.shardings(self.param_specs(), self.ctx)

    def param_partition_specs(self):
        return pm.partition_specs(self.param_specs(), self.ctx)

    def held_param_specs(self):
        """What each rank serves with of every parameter
        (`params.held_specs`): the partition spec a leaf of the parameters
        `init` gives, and the layout the model computes with on a mesh."""
        return pm.held_specs(self.param_specs(), self.cfg, self.ctx)

    def place(self, params):
        """The whole parameters (or any tree of their shapes: mu, nu) ->
        this rank's blocks by `param_partition_specs`
        (`params.placed_params`), the train state's layout on a mesh."""
        return pm.placed_params(params, self.cfg, self.ctx)

    def n_params(self) -> int:
        return pm.count(self.param_specs())

    # -------------------------------------------------------------- steps
    def loss(self, params, batch):
        return lm.loss_fn(params, batch, self.cfg, self.ctx)

    def prefill(self, params, batch, pad_to=None):
        return lm.prefill(params, batch, self.cfg, self.ctx, pad_to=pad_to)

    def decode_step(self, params, cache, batch):
        return lm.decode_step(params, cache, batch, self.cfg, self.ctx)

    def decode_step_paged(self, params, k_pools, v_pools, block_tables, lengths, batch):
        return lm.decode_step_paged(params, k_pools, v_pools, block_tables,
                                    lengths, batch, self.cfg, self.ctx)

    def prefill_chunk_paged(self, params, k_pools, v_pools, block_tables,
                            start, batch, n_valid):
        return lm.prefill_chunk_paged(params, k_pools, v_pools, block_tables,
                                      start, batch, n_valid, self.cfg,
                                      self.ctx)

    def supports_paged_decode(self) -> bool:
        return lm.supports_paged_decode(self.cfg)

    # -------------------------------------------------------------- cache
    def cache_specs(self, shape: ShapeSuite):
        return lm.cache_specs(self.cfg, shape)

    def abstract_cache(self, shape: ShapeSuite):
        """Meta tensors of the decode cache of `shape` (no memory)."""
        return pm.abstract(self.cache_specs(shape))

    def cache_partition_specs(self, shape: ShapeSuite):
        return pm.partition_specs(self.cache_specs(shape), self.ctx)

    def cache_shardings(self, shape: ShapeSuite):
        """Every leaf of the decode cache of `shape` by its rules on a mesh
        (the layout `runtime.steps.jit_decode_step` takes and returns),
        None without one."""
        return pm.shardings(self.cache_specs(shape), self.ctx)

    def place_cache(self, cache):
        """A whole decode cache (``{"pos", "layers"}``, every rank's rows)
        -> this rank's blocks of it placed as `cache_shardings` places
        them (`lm.place_caches`), with the whole K/V caches' lengths under
        ``"kv_len"`` on a mesh."""
        layers = cache["layers"]
        out = {"pos": cache["pos"],
               "layers": lm.place_caches(layers, self.cfg, self.ctx)}
        if self.ctx.mesh is not None:
            out["kv_len"] = {k: layers[k].shape[2] for k in ("k", "cross_k")
                             if k in layers}
        return out


def build_model(cfg: ArchConfig, ctx: ShardingCtx = NULL_CTX) -> Model:
    return Model(cfg=cfg, ctx=ctx)
