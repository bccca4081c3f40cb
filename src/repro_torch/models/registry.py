"""Model facade: bind an ArchConfig to the LM's paged serving functions."""
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
