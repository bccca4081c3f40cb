"""Named sharding-layout presets (the reference package's
``runtime/layouts.py``).

  training  - DP/FSDP + TP: parameters and optimizer state storage-sharded
              over the data axis (ZeRO) on top of tensor parallelism.
  serving   - pure TP residency: no data-axis storage sharding (decode
              touches every weight once a token, so FSDP re-gathers would
              be pure overhead), weights stored in bf16, and the
              row-granular KV write of the sequence-sharded decode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["SERVING", "TRAINING", "rules_for", "serving_config_overrides"]

TRAINING: Optional[Dict[str, Any]] = None  # sharding.DEFAULT_RULES

SERVING: Dict[str, Any] = {
    "embed": None,   # no FSDP storage sharding
    "fsdp": None,
}


def rules_for(layout: str) -> Optional[Dict[str, Any]]:
    """The rule overrides of a layout (None: the default rules)."""
    if layout in ("training", "default"):
        return TRAINING
    if layout == "serving":
        return dict(SERVING)
    raise ValueError(f"unknown layout {layout!r} (training|serving)")


def serving_config_overrides() -> Dict[str, Any]:
    """ArchConfig overrides that pair with the serving layout: bf16 weight
    storage (compute stays cfg.dtype) and the row-granular cache write
    (`models.common._row_update`), which only the sequence-sharded decode
    reads."""
    return {"param_dtype": "bfloat16", "cache_update": "row"}
