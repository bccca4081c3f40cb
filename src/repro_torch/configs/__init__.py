"""Registry of assigned architectures (``--arch <id>``)."""
from typing import Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r_plus_104b
from repro_torch.configs.granite_3_2b import CONFIG as _granite_3_2b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite_moe_1b_a400m
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba_1_5b
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma_3b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3_moe_30b_a3b
from repro_torch.configs.whisper_medium import CONFIG as _whisper_medium
from repro_torch.configs.yi_6b import CONFIG as _yi_6b

REGISTRY = {
    c.name: c
    for c in (
        _granite_3_2b,
        _command_r_plus_104b,
        _internlm2_20b,
        _yi_6b,
        _granite_moe_1b_a400m,
        _qwen3_moe_30b_a3b,
        _mamba2_130m,
        _hymba_1_5b,
        _whisper_medium,
        _paligemma_3b,
    )
}

ALL_ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def token_split(arch: ArchConfig, seq_len: int) -> Tuple[int, int]:
    """(frontend_positions, text_positions) for stub-frontend archs."""
    if arch.enc_dec:
        return seq_len, max(seq_len // arch.dec_ratio, 8)
    if arch.vlm:
        prefix = min(arch.prefix_len, seq_len // 2)
        return prefix, seq_len - prefix
    return 0, seq_len


__all__ = ["ALL_ARCH_NAMES", "ArchConfig", "REGISTRY", "get_config",
           "token_split"]
