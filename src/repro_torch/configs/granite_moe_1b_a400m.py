"""granite-moe-1b-a400m [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    kv_heads=8,
    d_ff=512,           # per-expert FFN width
    vocab=49155,
    moe=True,
    n_experts=32,
    top_k=8,
    d_ff_expert=512,
    tie_embeddings=True,
)
