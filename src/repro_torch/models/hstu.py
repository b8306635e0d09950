"""HSTU (Hierarchical Sequential Transduction Unit) block, forward only.

Jagged-native: every tensor is packed ``(cap, ...)`` (or ``(G, cap, ...)``
for G packs) with int32 row offsets. Attention is pointwise (softmax-free):

    U,V,Q,K = split(SiLU(f1(norm(X))))
    A       = SiLU(QK^T * scale + RAB(pos, time)) * same_seg_causal / (pos+1)
    Y       = f2(norm(A V) * U);  out = X + Y

The divisor is the per-query causal count (pos+1), not the row length: the
non-affine norm after it makes the two equivalent up to eps, but only the
per-query count keeps prefix hidden states unchanged as a user's sequence
grows, which the serving warm path relies on.

:func:`jagged_pointwise_attention` is the dense oracle and
:func:`jagged_pointwise_attention_blocked` the flash-style blocked scan;
the model's default attention is the plan-aware kernel wrapper in
``repro_torch.kernels.jagged_attention``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, RABConfig
from repro_torch.core.jagged import positions, segment_ids
from repro_torch.kernels.jagged_attention.ops import PlannedAttention

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# RAB — relative attention bias
# --------------------------------------------------------------------------

def pos_bucket(qpos: torch.Tensor, kpos: torch.Tensor,
               num_buckets: int) -> torch.Tensor:
    """Relative-position bucket: clip(qpos - kpos, 0, npb-1)."""
    d = qpos[..., :, None] - kpos[..., None, :]
    return d.clamp(0, num_buckets - 1)


def time_bucket(qt: torch.Tensor, kt: torch.Tensor,
                rab: RABConfig) -> torch.Tensor:
    """Bucketized |Δt|: floor(log10(1+Δt)/scale), clipped."""
    dt = (qt[..., :, None] - kt[..., None, :]).abs().to(torch.float32)
    b = torch.floor(torch.log10(1.0 + dt) / rab.time_bucket_scale)
    return b.to(torch.int64).clamp(0, rab.num_time_buckets - 1)


def rab_bias(p: Params, rab: RABConfig, qpos, kpos, qt, kt):
    """Bias (…, q, k, H) fp32 from the bucket tables (the oracle path)."""
    out = 0.0
    if rab.use_pos and "pos_table" in p:
        out = out + p["pos_table"][
            pos_bucket(qpos, kpos, rab.num_pos_buckets).long()]
    if rab.use_time and "time_table" in p:
        out = out + p["time_table"][time_bucket(qt, kt, rab)]
    return out


# --------------------------------------------------------------------------
# jagged pointwise attention — dense oracle + blocked scan
# --------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def jagged_pointwise_attention(q, k, v, offsets, timestamps, rab_params,
                               rab: Optional[RABConfig], *,
                               time_mode: str = "bucket") -> torch.Tensor:
    """Oracle: full (cap, cap) materialization. q,k (cap,H,dqk), v
    (cap,H,dv) → (cap,H,dv) v.dtype."""
    if time_mode != "bucket":
        raise NotImplementedError(time_mode)
    cap, H, dqk = q.shape
    scale = 1.0 / math.sqrt(dqk)
    seg = segment_ids(offsets, cap)
    pos = positions(offsets, cap)
    slot = torch.arange(cap, device=q.device)
    s = torch.einsum("qhd,khd->qkh", q.float(), k.float()) * scale
    if rab is not None:
        s = s + rab_bias(rab_params, rab, pos, pos, timestamps, timestamps)
    a = _silu(s)
    mask = ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
            & (slot[:, None] >= slot[None, :]))
    a = torch.where(mask[..., None], a, 0.0) / (pos + 1)[:, None, None].float()
    out = torch.einsum("qkh,khd->qhd", a.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def jagged_pointwise_attention_blocked(q, k, v, offsets, timestamps,
                                       rab_params, rab: Optional[RABConfig],
                                       *, block: int = 512,
                                       time_mode: str = "bucket"
                                       ) -> torch.Tensor:
    """Double-blocked scan, O(block²·H) scores at a time, same math as the
    oracle (divide by n once after the key loop)."""
    if time_mode != "bucket":
        raise NotImplementedError(time_mode)
    cap, H, dqk = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dqk)
    block = min(block, cap)
    if cap % block:
        raise ValueError(f"capacity {cap} is not a multiple of block {block}")
    nb = cap // block
    seg = segment_ids(offsets, cap)
    pos = positions(offsets, cap)
    slot = torch.arange(cap, device=q.device)
    n_row = pos + 1
    out = torch.empty((cap, H, dv), dtype=v.dtype, device=v.device)
    for qi in range(nb):
        qs = slice(qi * block, (qi + 1) * block)
        acc = torch.zeros((block, H, dv), dtype=torch.float32,
                          device=q.device)
        for ki in range(nb):
            ks = slice(ki * block, (ki + 1) * block)
            s = torch.einsum("qhd,khd->qkh", q[qs].float(),
                             k[ks].float()) * scale
            if rab is not None:
                s = s + rab_bias(rab_params, rab, pos[qs], pos[ks],
                                 timestamps[qs], timestamps[ks])
            a = _silu(s)
            m = ((seg[qs][:, None] == seg[ks][None, :])
                 & (seg[qs][:, None] >= 0)
                 & (slot[qs][:, None] >= slot[ks][None, :]))
            a = torch.where(m[..., None], a, 0.0)
            acc = acc + torch.einsum("qkh,khd->qhd", a.to(v.dtype).float(),
                                     v[ks].float())
        out[qs] = (acc / n_row[qs][:, None, None].float()).to(v.dtype)
    return out


# --------------------------------------------------------------------------
# HSTU block
# --------------------------------------------------------------------------

class HSTUBlock(nn.Module):
    """One HSTU block's parameters, laid out as the JAX package's pytree:
    ``w_uvqk`` (d, H·(2dv+2dqk)) splits in u, v, q, k order; the RAB tables
    stay fp32 whatever the weights' dtype."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        dqk = cfg.qkv_dim or cfg.resolved_head_dim
        dv = dqk
        kw = dict(device=device, generator=generator)

        def normal(*shape):
            return torch.randn(*shape, dtype=torch.float32, **kw)

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.ln_w = param(torch.ones(d, dtype=dtype, device=device))
        self.ln_b = param(torch.zeros(d, dtype=dtype, device=device))
        self.w_uvqk = param((normal(d, H * (2 * dv + 2 * dqk))
                             / math.sqrt(d)).to(dtype))
        self.w_o = param((normal(H * dv, d)
                          / math.sqrt(H * dv * 2 * cfg.num_layers)).to(dtype))
        self.rab = nn.ParameterDict()
        if cfg.rab is not None:
            if cfg.rab.use_pos:
                self.rab["pos_table"] = param(
                    normal(cfg.rab.num_pos_buckets, H) * 0.02)
            if cfg.rab.use_time:
                self.rab["time_table"] = param(
                    normal(cfg.rab.num_time_buckets, H) * 0.02)


def _block_norm(x: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def _hstu_uvqk(p: HSTUBlock, cfg: ArchConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """Row-local front half: norm → SiLU(f1) → split. x (…, n, d) →
    u (…, n, H·dv), v (…, n, H, dv), q (…, n, H, dqk), k (…, n, H, dqk)."""
    H = cfg.num_heads
    dqk = cfg.qkv_dim or cfg.resolved_head_dim
    dv = dqk
    lead = x.shape[:-1]
    h = _block_norm(x, p.ln_w, p.ln_b, cfg.norm_eps)
    uvqk = _silu(h @ p.w_uvqk)
    u, v, q, k = torch.split(uvqk, [H * dv, H * dv, H * dqk, H * dqk], dim=-1)
    return (u, v.reshape(*lead, H, dv), q.reshape(*lead, H, dqk),
            k.reshape(*lead, H, dqk))


def _hstu_output(p: HSTUBlock, cfg: ArchConfig, x: torch.Tensor,
                 y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row-local back half: non-affine LN of the attention output, gated by
    U, projected by f2, residual. y (…, n, H, dv)."""
    y = y.reshape(*y.shape[:-2], -1)
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
    return x + (yn * u) @ p.w_o


def default_attn_fn(cfg: ArchConfig) -> Callable:
    """The kernel-backed work-list attention for every HSTU config, on any
    device (max_row_len = cfg.max_seq_len bounds the work-list). The
    wrapper picks the kernel or the plain version by where the tensors
    lie."""
    if (cfg.gr_block or "hstu") != "hstu":
        raise NotImplementedError(
            f"gr_block={cfg.gr_block!r}: only HSTU is ported so far")
    return PlannedAttention(block=128, max_row_len=cfg.max_seq_len)


def hstu_block(p: HSTUBlock, cfg: ArchConfig, x: torch.Tensor,
               offsets: torch.Tensor, timestamps: torch.Tensor, *,
               attn_fn=None, time_mode: str = "bucket",
               plan=None) -> torch.Tensor:
    """One HSTU block over packed tokens x (cap, d) or (G, cap, d).

    ``attn_fn`` defaults to :func:`default_attn_fn`. ``plan`` is a
    precomputed attention plan forwarded to a plan-aware ``attn_fn``,
    which takes all G packs in one call."""
    u, v, q, k = _hstu_uvqk(p, cfg, x)
    attn_fn = attn_fn or default_attn_fn(cfg)
    rab_params = dict(p.rab.items())
    kw = {"plan": plan} if plan is not None else {}
    y = attn_fn(q, k, v, offsets, timestamps, rab_params, cfg.rab,
                time_mode=time_mode, **kw)
    return _hstu_output(p, cfg, x, y, u)
