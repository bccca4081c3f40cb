"""command-r-plus-104b [dense] — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    kv_heads=8,
    d_ff=33792,
    vocab=256000,
    use_bias=False,
    tie_embeddings=True,
)
