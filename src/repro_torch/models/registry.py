"""Model facade: bind an ArchConfig to the LM's functions (the training
loss, the dense engine's prefill and decode step, the paged engine's
steps)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models import params as pm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ------------------------------------------------------------- params
    def param_specs(self):
        return lm.param_specs(self.cfg)

    def init(self, generator: torch.Generator, device):
        """Random parameters on `device`, drawn from `generator` (which
        must live on that device)."""
        return pm.initialize(self.param_specs(), generator, device)

    def n_params(self) -> int:
        return pm.count(self.param_specs())

    # -------------------------------------------------------------- steps
    def loss(self, params, batch):
        return lm.loss_fn(params, batch, self.cfg)

    def prefill(self, params, batch, pad_to=None):
        return lm.prefill(params, batch, self.cfg, pad_to=pad_to)

    def decode_step(self, params, cache, batch):
        return lm.decode_step(params, cache, batch, self.cfg)

    def decode_step_paged(self, params, k_pools, v_pools, block_tables, lengths, batch):
        return lm.decode_step_paged(params, k_pools, v_pools, block_tables,
                                    lengths, batch, self.cfg)

    def prefill_chunk_paged(self, params, k_pools, v_pools, block_tables,
                            start, batch, n_valid):
        return lm.prefill_chunk_paged(params, k_pools, v_pools, block_tables,
                                      start, batch, n_valid, self.cfg)

    def supports_paged_decode(self) -> bool:
        return lm.supports_paged_decode(self.cfg)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)
