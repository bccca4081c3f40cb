"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    kv_heads=8,
    d_ff=8192,
    vocab=49155,
    tie_embeddings=True,
)
