"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    n_layers=24,
    d_model=768,
    n_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    tie_embeddings=True,
)
