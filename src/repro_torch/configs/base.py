"""Architecture configuration schema.

Every assigned architecture is expressed as an ``ArchConfig`` with its
exact published dims; ``reduced()`` derives a small same-family config for
CPU tests. The port serves the full configs on a GPU.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str = ""
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""       # provenance tag from the assignment table

    # transformer backbone --------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 0              # dense FFN width (for MoE: dense path unused)
    vocab: int = 0
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    sliding_window: int = 0    # 0 = full attention

    # MoE ------------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba-2 SSD) ------------------------------------------------------
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # §Perf: shard-aligned split projections + head-dim TP for the SSD
    # (joint in_proj slicing at non-shard boundaries forces GSPMD permutes)
    ssm_split_proj: bool = False

    # hybrid (parallel attn + ssm heads, Hymba-style) ------------------------
    hybrid: bool = False

    # encoder-decoder (Whisper backbone; conv frontend is a stub) ------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    dec_ratio: int = 4         # decoder seq = seq_len // dec_ratio

    # VLM (PaliGemma backbone; SigLIP frontend is a stub) ---------------------
    vlm: bool = False
    prefix_len: int = 0        # number of patch-embedding positions

    # runtime knobs -----------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"      # storage dtype (serving: bfloat16)
    cache_update: str = "full"        # decode KV write: full | row (§Perf)
    scan_layers: bool = True          # False for dry-run (exact cost analysis)
    remat: bool = True
    remat_policy: str = "nothing"     # nothing | dots | none
    attn_impl: str = "auto"           # auto | naive | chunked
    attn_chunk: int = 1024
    use_kernels: bool = False         # kept for field parity; unused here
    moe_impl: str = "auto"            # auto | dense | ep (expert-parallel a2a)

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (O(seq) or better)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers [+ head])."""
        hd = self.resolved_head_dim
        embed = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        attn = (
            self.d_model * self.n_heads * hd          # q
            + 2 * self.d_model * self.kv_heads * hd   # k, v
            + self.n_heads * hd * self.d_model        # o
        )
        if self.moe:
            ffn = self.n_experts * 3 * self.d_model * self.d_ff_expert
            ffn += self.d_model * self.n_experts      # router
        else:
            ffn = 3 * self.d_model * self.d_ff
        ssm = 0
        if self.ssm or self.hybrid:
            di, ns = self.d_inner, self.ssm_state
            ssm = (
                self.d_model * (2 * di + 2 * ns + self.ssm_heads)  # in_proj
                + (di + 2 * ns) * self.conv_width                  # conv
                + di * self.d_model                                # out_proj
                + 3 * self.ssm_heads                               # A, dt_bias, D
            )
        per_layer = 2 * self.d_model  # norms
        if self.family == "ssm":
            per_layer += ssm
        elif self.hybrid:
            per_layer += attn + ffn + ssm
        else:
            per_layer += attn + ffn
        n_l = self.n_layers + (self.n_enc_layers if self.enc_dec else 0)
        cross = 0
        if self.enc_dec:  # decoder cross-attention blocks
            cross = self.n_layers * (attn + self.d_model)
        return embed + head + n_l * per_layer + cross

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.n_params()
        dense_like = self.replace(
            moe=False, d_ff=self.top_k * self.d_ff_expert, n_experts=0
        )
        return dense_like.n_params() + self.n_layers * self.d_model * self.n_experts

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return self.replace(
            name=self.name + "-smoke",
            n_layers=2,
            n_enc_layers=2 if self.enc_dec else 0,
            d_model=64,
            n_heads=4,
            kv_heads=max(1, min(self.kv_heads, 2)),
            head_dim=16 if self.head_dim else 0,
            d_ff=128,
            d_ff_expert=32 if self.moe else 0,
            n_experts=4 if self.moe else 0,
            top_k=2 if self.moe else 0,
            vocab=256,
            ssm_state=16 if (self.ssm or self.hybrid) else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            prefix_len=8 if self.vlm else 0,
            sliding_window=32 if self.sliding_window else 0,
            attn_chunk=32,
            scan_layers=True,
        )
