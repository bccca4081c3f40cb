"""paligemma-3b [vlm] — SigLIP + gemma backbone; the SigLIP frontend is a STUB
(input_specs() provides precomputed patch embeddings for the prefix).
[arXiv:2407.07726; hf]

Gemma-2B decoder dims: 18L, d_model 2048, 8 heads with head_dim 256 (q width
2048), MQA kv=1, d_ff 16384.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726; hf",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    vlm=True,
    prefix_len=256,        # SigLIP 224px/14 -> 256 patch positions
    tie_embeddings=True,
)
