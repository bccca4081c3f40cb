"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Note: Qwen3 uses an explicit head_dim=128 (q width 4096 > d_model 2048),
matching the HF config.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    kv_heads=4,
    head_dim=128,
    d_ff=768,           # per-expert FFN width
    vocab=151936,
    moe=True,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    rope_theta=1_000_000.0,
)
