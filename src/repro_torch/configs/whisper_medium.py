"""whisper-medium [audio] — enc-dec transformer backbone; the conv frontend is a
STUB (input_specs() provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356; unverified",
    n_layers=24,           # decoder layers
    n_enc_layers=24,       # encoder layers
    d_model=1024,
    n_heads=16,
    kv_heads=16,           # full MHA
    d_ff=4096,
    vocab=51865,
    use_bias=True,
    enc_dec=True,
    dec_ratio=4,           # decoder seq = seq_len // 4
    tie_embeddings=True,
)
