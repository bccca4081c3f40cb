"""Mamba-2 SSD (state-space duality) block: chunked prefill and O(1) decode.

The chunked SSD streams sequence chunks through a small recurrent state:
the paper's coroutine pipeline, with the inter-chunk state as its
*sequential* context variable. On a zero initial state `ssd_chunked` runs
the SSD-scan kernel and, under grad, its backward kernel (`kernels/ssd_scan`:
the CUDA kernels on CUDA tensors, their plain versions on CPU ones);
`chunked_ssd` is the reference's chunked
math in torch ops, the kernel's plain version and the path for a given
initial state. Layouts and names follow the reference package
(``src/repro/models/ssm.py``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models.common import rms_norm
from repro_torch.models.params import ParamSpec

__all__ = ["chunked_ssd", "ssd_chunked", "ssd_sequential", "ssm_cache_shape",
           "ssm_decode", "ssm_dims", "ssm_forward", "ssm_param_specs"]

# ----------------------------------------------------------------- SSD math


def ssd_sequential(x, dt, A, B, C, h0=None):
    """Reference recurrence. x:[b,s,h,p] dt:[b,s,h] A:[h] B,C:[b,s,n].

    h_t = h_{t-1} * exp(A*dt_t) + dt_t * x_t outer B_t ;  y_t = h_t . C_t
    Returns (y [b,s,h,p], h_final [b,h,p,n] f32)."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    h = torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    A = A.float()
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                                  # [b,h]
        decay = torch.exp(dtt * A)[..., None, None]
        h = h * decay + (dtt[..., None, None] * x[:, t].float()[..., None]
                         * B[:, t].float()[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h


def chunked_ssd(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD (Mamba-2 Alg. 1, single B/C group) in torch ops, f32: the
    reference's `ssd_chunked` math. `s` must be a multiple of `chunk`.

    The decay matrix is formed one head at a time, masked before the
    exponent (no positive argument is exponentiated, so a strong decay
    stays finite). Returns (y [b,s,h,p] in x's type, h_final [b,h,p,n])."""
    b, s, nh, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    h = torch.zeros((b, nh, p, n), dtype=f32, device=x.device) \
        if h0 is None else h0.float()
    xc = x.reshape(b, nc, chunk, nh, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, nh).to(f32)
    Bc = B.reshape(b, nc, chunk, n).to(f32)
    Cc = C.reshape(b, nc, chunk, n).to(f32)

    cs = torch.cumsum(dtc * A.to(f32), dim=2)              # [b,nc,q,h] (<= 0)
    total = cs[:, :, -1:, :]                               # [b,nc,1,h]
    dtx = xc * dtc[..., None]                              # [b,nc,q,h,p]

    # intra-chunk (attention-like) term, one head at a time
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)       # [b,nc,q,k]
    above = ~torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    y_intra = torch.empty_like(xc)
    for hh in range(nh):
        seg = cs[..., hh, None] - cs[..., None, :, hh]     # [b,nc,q,k]
        L = torch.exp(seg.masked_fill(above, float("-inf")))
        y_intra[..., hh, :] = torch.einsum("bcqk,bckp->bcqp", scores * L,
                                           dtx[..., hh, :])

    # per-chunk input state contribution, then the inter-chunk recurrence
    decay_to_end = torch.exp(total - cs)                   # [b,nc,q,h]
    s_chunk = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                           dtx * decay_to_end[..., None])  # [b,nc,h,p,n]
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(total[:, c, 0])[..., None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                   # [b,nc,h,p,n]

    # inter-chunk output term
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(b, s, nh, p).to(x.dtype)
    return y, h


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD with the reference's dispatch: the sequential recurrence
    when `s` is not a multiple of `chunk`; on a zero initial state the
    SSD-scan kernel through its `autograd.Function` (`ops.ssd`: the forward
    kernel, and the backward kernel under grad); from a given state `h0`,
    `chunked_ssd`. Same signature and result as `ssd_sequential`."""
    s = x.shape[1]
    if s % chunk != 0:
        return ssd_sequential(x, dt, A, B, C, h0)
    if h0 is None:
        return ssd(x, dt, A, B, C, chunk=chunk)
    return chunked_ssd(x, dt, A, B, C, chunk, h0)


# ------------------------------------------------------------ block plumbing


def ssm_dims(cfg: ArchConfig) -> Dict[str, int]:
    di = cfg.d_inner
    n = cfg.ssm_state
    nh = cfg.ssm_heads
    return dict(
        di=di, n=n, nh=nh, p=cfg.ssm_head_dim,
        conv_dim=di + 2 * n,
        d_in_proj=2 * di + 2 * n + nh,
    )


SPLIT_REFUSED = ("ssm_split_proj is a training-layout optimization; "
                 "decode/prefill cache handoff uses the joint in_proj layout")


def ssm_param_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    """The joint ``in_proj`` layout (the one the decode cache hand-off
    uses) or, with ``ssm_split_proj``, the reference's split training
    layout: z and x projected per (head, head_dim), B, C and dt each by
    their own matrix, with their own depthwise convs."""
    d = ssm_dims(cfg)
    dm = cfg.d_model
    common = {
        "A_log": ParamSpec((d["nh"],), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamSpec((d["nh"],), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((d["nh"],), ("ssm_heads",), init="ones"),
        "norm_w": ParamSpec((d["di"],), ("d_inner",), init="ones"),
    }
    if cfg.ssm_split_proj:
        nh, p, n, w = d["nh"], d["p"], d["n"], cfg.conv_width
        return {
            **common,
            "w_z": ParamSpec((dm, nh, p), ("embed", "ssm_heads", "head_dim"),
                             init="fan_in"),
            "w_x": ParamSpec((dm, nh, p), ("embed", "ssm_heads", "head_dim"),
                             init="fan_in"),
            "w_B": ParamSpec((dm, n), ("embed", "ssm_state"), init="fan_in"),
            "w_C": ParamSpec((dm, n), ("embed", "ssm_state"), init="fan_in"),
            "w_dt": ParamSpec((dm, nh), ("embed", "ssm_heads"),
                              init="fan_in"),
            "conv_x": ParamSpec((w, nh, p), ("width", "ssm_heads", "head_dim"),
                                init="fan_in"),
            "conv_B": ParamSpec((w, n), ("width", "ssm_state"), init="fan_in"),
            "conv_C": ParamSpec((w, n), ("width", "ssm_state"), init="fan_in"),
            "conv_bx": ParamSpec((nh, p), ("ssm_heads", "head_dim"),
                                 init="zeros"),
            "conv_bB": ParamSpec((n,), ("ssm_state",), init="zeros"),
            "conv_bC": ParamSpec((n,), ("ssm_state",), init="zeros"),
            "out_proj": ParamSpec((nh, p, dm), ("ssm_heads", "head_dim",
                                                "embed"), init="fan_in"),
        }
    return {
        **common,
        "in_proj": ParamSpec((dm, d["d_in_proj"]), ("embed", "d_inner"),
                             init="fan_in"),
        "conv_w": ParamSpec((cfg.conv_width, d["conv_dim"]),
                            ("width", "conv_dim"), init="fan_in"),
        "conv_b": ParamSpec((d["conv_dim"],), ("conv_dim",), init="zeros"),
        "out_proj": ParamSpec((d["di"], dm), ("d_inner", "embed"),
                              init="fan_in"),
    }


def _split_proj(zxbcdt, cfg: ArchConfig):
    d = ssm_dims(cfg)
    z = zxbcdt[..., : d["di"]]
    xBC = zxbcdt[..., d["di"]: d["di"] + d["conv_dim"]]
    dt = zxbcdt[..., d["di"] + d["conv_dim"]:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along seq. xBC:[B,S,*C], w:[W,*C], b:[*C]
    (C one axis, or the split layout's (heads, head_dim))."""
    width = w.shape[0]
    s = xBC.shape[1]
    pad = F.pad(xBC, (0, 0) * (xBC.dim() - 2) + (width - 1, 0))
    out = pad[:, 0:s] * w[0][None, None]
    for i in range(1, width):
        out = out + pad[:, i: i + s] * w[i][None, None]
    return out + b[None, None]


def _forward_split(p, x, cfg: ArchConfig, h0=None, return_state=False):
    """The split layout's full-sequence SSD block (training only): per-piece
    projections and depthwise convs, then the chunked SSD as in the joint
    layout. Decode and prefill refuse it: their cache hand-off uses the
    joint layout."""
    if return_state:
        raise NotImplementedError(SPLIT_REFUSED)
    d = ssm_dims(cfg)
    dt_ = x.dtype
    nh, pp = d["nh"], d["p"]
    b, s, _ = x.shape
    z = torch.einsum("bsd,dhp->bshp", x, p["w_z"].to(dt_))
    xh = torch.einsum("bsd,dhp->bshp", x, p["w_x"].to(dt_))
    Bs = x @ p["w_B"].to(dt_)
    Cs = x @ p["w_C"].to(dt_)
    dt = x @ p["w_dt"].to(dt_)
    xh = F.silu(_causal_conv(xh, p["conv_x"].to(dt_), p["conv_bx"].to(dt_)))
    Bs = F.silu(_causal_conv(Bs, p["conv_B"].to(dt_), p["conv_bB"].to(dt_)))
    Cs = F.silu(_causal_conv(Cs, p["conv_C"].to(dt_), p["conv_bC"].to(dt_)))
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, _ = ssd_chunked(xh, dt, A, Bs, Cs, cfg.ssm_chunk, h0)
    y = y + p["D"].to(y.dtype)[:, None] * xh
    g = (y * F.silu(z)).reshape(b, s, nh * pp)
    g = rms_norm(g, p["norm_w"], cfg.norm_eps).reshape(b, s, nh, pp)
    return torch.einsum("bshp,hpd->bsd", g, p["out_proj"].to(dt_))


def ssm_forward(p, x, cfg: ArchConfig, h0=None, conv0=None,
                return_state=False):
    """Full-sequence SSD block. x: [B,S,d_model] -> [B,S,d_model]; with
    `return_state`, also the final SSM state [B,H,P,N] (f32) and the conv
    state (the last W-1 pre-activation xBC rows). The split layout
    (``w_x`` in `p`) takes `_forward_split`, which has no state."""
    if cfg.ssm_split_proj and "w_x" in p:
        if conv0 is not None:
            raise NotImplementedError(SPLIT_REFUSED)
        return _forward_split(p, x, cfg, h0, return_state)
    d = ssm_dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC_in, dt = _split_proj(zxbcdt, cfg)
    conv_w, conv_b = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if conv0 is not None:
        ext = torch.cat([conv0.to(xBC_in.dtype), xBC_in], dim=1)
        xBC = _causal_conv(ext, conv_w, conv_b)[:, conv0.shape[1]:]
    else:
        xBC = _causal_conv(xBC_in, conv_w, conv_b)
    xBC = F.silu(xBC)
    xs = xBC[..., : d["di"]]
    Bs = xBC[..., d["di"]: d["di"] + d["n"]]
    Cs = xBC[..., d["di"] + d["n"]:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(*xs.shape[:-1], d["nh"], d["p"])
    y, h_fin = ssd_chunked(xh, dt, A, Bs, Cs, cfg.ssm_chunk, h0)
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(*xs.shape)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        zx = xBC_in
        if conv0 is not None:
            zx = torch.cat([conv0.to(zx.dtype), zx], dim=1)
        conv_state = zx[:, -(cfg.conv_width - 1):, :]
        return out, h_fin, conv_state
    return out


def ssm_decode(p, cache: Dict[str, torch.Tensor], x, cfg: ArchConfig):
    """One-token decode. x: [B,1,d_model]; cache: {"h": [B,H,P,N] f32,
    "conv": [B,W-1,conv_dim]}. Returns (out, new cache). The split
    layout is refused."""
    if "w_x" in p:
        raise NotImplementedError(SPLIT_REFUSED)
    d = ssm_dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    ext = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)
    conv_out = _causal_conv(ext, p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype))
    new_conv = ext[:, 1:, :]
    xBC = F.silu(conv_out[:, -1:, :])
    xs = xBC[..., : d["di"]]
    Bs = xBC[..., d["di"]: d["di"] + d["n"]][:, 0]
    Cs = xBC[..., d["di"] + d["n"]:][:, 0]
    dt = F.softplus(dt.float() + p["dt_bias"].float())[:, 0]    # [B,H]
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(xs.shape[0], d["nh"], d["p"])                 # [B,H,P]
    decay = torch.exp(dt * A)[..., None, None]
    h = cache["h"] * decay + dt[..., None, None] * xh[..., None].float() \
        * Bs[:, None, None, :].float()
    y = torch.einsum("bhpn,bn->bhp", h, Cs.float()).to(x.dtype)
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.reshape(x.shape[0], 1, d["di"])
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"h": h, "conv": new_conv.to(x.dtype)}


def ssm_cache_shape(cfg: ArchConfig,
                    batch: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d = ssm_dims(cfg)
    return {
        "h": ((batch, d["nh"], d["p"], d["n"]), "float32"),
        "conv": ((batch, cfg.conv_width - 1, d["conv_dim"]), cfg.dtype),
    }


