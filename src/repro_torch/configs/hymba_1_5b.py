"""hymba-1.5b [hybrid] — parallel attn + mamba heads within each layer.
[arXiv:2411.13676; hf]

Attention heads run sliding-window (Hymba uses SWA in all but 3 layers; we use
SWA uniformly, noted in DESIGN.md) which keeps the arch sub-quadratic and
eligible for the 500k-token decode shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676; hf",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    kv_heads=5,
    d_ff=5504,
    vocab=32001,
    hybrid=True,
    ssm=True,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    sliding_window=1024,
    tie_embeddings=True,
)
