"""HSTU (Hierarchical Sequential Transduction Unit) block.

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
from repro_torch.kernels.jagged_attention import ops as attn_ops
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


def rab_bias(p: Params, rab: RABConfig, qpos, kpos, qt, kt,
             time_mode: str = "bucket"):
    """Bias (…, q, k, H) fp32 (the oracle path): the position table plus,
    by ``time_mode``, the time table ("bucket", HSTU) or the functional
    time encoder ("functional", FuXi)."""
    if time_mode not in ("bucket", "functional"):
        raise ValueError(f"unknown time_mode {time_mode!r}")
    out = 0.0
    if rab.use_pos and "pos_table" in p:
        out = out + p["pos_table"][
            pos_bucket(qpos, kpos, rab.num_pos_buckets).long()]
    if time_mode == "functional":
        return out + functional_time_bias(p, qt, kt)
    if rab.use_time and "time_table" in p:
        out = out + p["time_table"][time_bucket(qt, kt, rab)]
    return out


def functional_time_bias(p: Params, qt, kt) -> torch.Tensor:
    """FuXi's exponential-power temporal encoder (table-free), (…, q, k, H)
    fp32: bias_h(Δt) = amp_h · exp(−((Δt + ε) / σ_h)^ρ_h), σ = exp(log σ),
    ρ = sigmoid(time_rho)·1.5 + 0.25 ∈ (0.25, 1.75). The oracle's form,
    with ``torch.pow``; the kernels and their plain versions compute
    exp(ρ·ln z)."""
    dt = (qt[..., :, None] - kt[..., None, :]).abs().to(torch.float32)
    sigma = torch.exp(p["time_log_sigma"])
    rho = torch.sigmoid(p["time_rho"]) * 1.5 + 0.25
    z = (dt[..., None] + 1e-6) / sigma
    return p["time_amp"] * torch.exp(-torch.pow(z, rho))


# --------------------------------------------------------------------------
# jagged pointwise attention — dense oracle + blocked scan
# --------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _row_count(offsets: torch.Tensor, seg: torch.Tensor, pos: torch.Tensor,
               causal: bool) -> torch.Tensor:
    """The per-query divisor n: pos+1 when causal, else the row's length
    (at least 1)."""
    if causal:
        return pos + 1
    lengths = offsets[1:] - offsets[:-1]
    segc = seg.clamp(0, offsets.shape[0] - 2).long()
    return lengths[segc].clamp(min=1)


def _mask(qseg, kseg, qslot, kslot, causal: bool) -> torch.Tensor:
    """(q, k) bool: one row, and the key at or before the query when
    ``causal``."""
    m = (qseg[:, None] == kseg[None, :]) & (qseg[:, None] >= 0)
    if causal:
        m &= qslot[:, None] >= kslot[None, :]
    return m


def jagged_pointwise_attention(q, k, v, offsets, timestamps, rab_params,
                               rab: Optional[RABConfig], *,
                               time_mode: str = "bucket",
                               causal: bool = True) -> torch.Tensor:
    """Oracle: full (cap, cap) materialization. q,k (cap,H,dqk), v
    (cap,H,dv) → (cap,H,dv) v.dtype. ``time_mode`` "bucket" (HSTU's time
    table) or "functional" (FuXi's encoder). ``causal=False``: every key
    of the row, weights over the row length."""
    cap, H, dqk = q.shape
    scale = 1.0 / math.sqrt(dqk)
    seg = segment_ids(offsets, cap)
    pos = positions(offsets, cap)
    slot = torch.arange(cap, device=q.device)
    s = torch.einsum("qhd,khd->qkh", q.float(), k.float()) * scale
    if rab is not None:
        s = s + rab_bias(rab_params, rab, pos, pos, timestamps,
                         timestamps, time_mode)
    a = _silu(s)
    mask = _mask(seg, seg, slot, slot, causal)
    n = _row_count(offsets, seg, pos, causal)
    a = torch.where(mask[..., None], a, 0.0) / n[:, None, None].float()
    out = torch.einsum("qkh,khd->qhd", a.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def jagged_pointwise_attention_blocked(q, k, v, offsets, timestamps,
                                       rab_params, rab: Optional[RABConfig],
                                       *, block: int = 512,
                                       time_mode: str = "bucket",
                                       causal: bool = True
                                       ) -> torch.Tensor:
    """Double-blocked scan, O(block²·H) scores at a time, same math as the
    oracle (divide by n once after the key loop)."""
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
    n_row = _row_count(offsets, seg, pos, causal)
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
                                 timestamps[qs], timestamps[ks], time_mode)
            a = _silu(s)
            m = _mask(seg[qs], seg[ks], slot[qs], slot[ks], causal)
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
            return nn.Parameter(t)

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


# PyTorch's CUDA row reduction splits each row over several blocks when a
# tensor has few rows (on the H100 at d 1024: fewer than 16), so the sum
# of a row would take another order, and its fp32 mean or variance
# another last bit, in a small tensor than in a large one. The serving
# warm path normalises its few window rows and must give the bits a cold
# encode gives on thousands: on the card every norm takes its statistics
# over at least ROW_STATS_MIN_ROWS rows, zero rows padding fewer. On the
# CPU the statistics are taken as they come (the CPU tests hold the warm
# path's bits there).
ROW_STATS_MIN_ROWS = 128


def _row_stats(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and (biased) variance over the last dim of fp32 ``xf``
    (…, d) → two (…, 1), each row's bits independent of the row count."""
    lead, d = xf.shape[:-1], xf.shape[-1]
    m = lead.numel()
    pad = xf.is_cuda and m < ROW_STATS_MIN_ROWS
    flat = (torch.cat([xf.reshape(m, d),
                       xf.new_zeros(ROW_STATS_MIN_ROWS - m, d)])
            if pad else xf)
    mu = flat.mean(-1, keepdim=True)
    var = ((flat - mu) ** 2).mean(-1, keepdim=True)
    if pad:
        mu, var = mu[:m].reshape(*lead, 1), var[:m].reshape(*lead, 1)
    return mu, var


def _block_norm(x: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu, var = _row_stats(x)
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
    mu, var = _row_stats(yf)
    yn = ((yf - mu) * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
    return x + (yn * u) @ p.w_o


def default_attn_fn(cfg: ArchConfig) -> Optional[Callable]:
    """The kernel-backed work-list attention for every HSTU and FuXi
    config, on any device (max_row_len = cfg.max_seq_len bounds the
    work-list); None for SASRec, whose block inlines its softmax
    attention. The block passes its time mode ("functional" for FuXi) on
    each call; the wrapper picks the kernel or the plain version by where
    the tensors lie."""
    kind = cfg.gr_block or "hstu"
    if kind == "sasrec":
        return None
    if kind not in ("hstu", "fuxi"):
        raise NotImplementedError(f"gr_block={kind!r}: not ported yet")
    return PlannedAttention(block=128, max_row_len=cfg.max_seq_len)


def hstu_block_kv(p: HSTUBlock, cfg: ArchConfig, x: torch.Tensor,
                  offsets: torch.Tensor, timestamps: torch.Tensor, *,
                  attn_fn=None, time_mode: str = "bucket", plan=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`hstu_block` that also returns the block's K/V projections
    (…, cap, H, ·): the serving cold path seeds the slots' K/V caches from
    them."""
    u, v, q, k = _hstu_uvqk(p, cfg, x)
    attn_fn = attn_fn or default_attn_fn(cfg)
    rab_params = dict(p.rab.items())
    kw = {"plan": plan} if plan is not None else {}
    y = attn_fn(q, k, v, offsets, timestamps, rab_params, cfg.rab,
                time_mode=time_mode, **kw)
    return _hstu_output(p, cfg, x, y, u), k, v


def hstu_block(p: HSTUBlock, cfg: ArchConfig, x: torch.Tensor,
               offsets: torch.Tensor, timestamps: torch.Tensor, *,
               attn_fn=None, time_mode: str = "bucket",
               plan=None) -> torch.Tensor:
    """One HSTU block over packed tokens x (cap, d) or (G, cap, d);
    ``time_mode`` reaches ``attn_fn`` ("functional" from the FuXi block).

    ``attn_fn`` defaults to :func:`default_attn_fn`. ``plan`` is a
    precomputed attention plan forwarded to a plan-aware ``attn_fn``,
    which takes all G packs in one call."""
    return hstu_block_kv(p, cfg, x, offsets, timestamps, attn_fn=attn_fn,
                         time_mode=time_mode, plan=plan)[0]


# --------------------------------------------------------------------------
# incremental prefix reuse: the serving warm path
# --------------------------------------------------------------------------

def pointwise_attention_append(q, k_cache, v_cache, rows, timestamps,
                               prefix_len, total_len, ninv, rab_params,
                               rab: Optional[RABConfig], *,
                               time_mode: str = "bucket") -> torch.Tensor:
    """The warm path's attention: the appended tokens' queries q
    (R, Q, H, dqk) at rows [p_r, p_r + Q) of slot ``rows[r]`` against keys
    [0, p_r + Q) of the layer's caches (N+1, cap, H, ·) (the new
    projections already in), for rows of ``total_len`` T_r = p_r + n_r
    live tokens. K1-fwd's append launch on the card, its plain version on
    the CPU: both follow K1-fwd's per-query arithmetic (the SiLU weights
    scaled by 1/(pos+1) and rounded to v's dtype before a·v, the same
    k-block walk), so every live query gets the bits a cold encode of its
    row gives; the reference's XLA order is not followed. Window rows at
    or past T_r come out 0. ``timestamps`` (R, cap) and ``ninv`` (cap,)
    (``ops.position_ninv``) as the launch takes them. Causal only: the
    cold encodes that filled the caches must be causal."""
    H, dqk = q.shape[-2:]
    pt, tt, tkw = attn_ops.rab_tables(rab_params, rab, H, q.device,
                                      time_mode)
    return attn_ops.attention_append(
        q.contiguous(), k_cache, v_cache, rows, timestamps, prefix_len,
        total_len, pt, tt, ninv, scale=1.0 / math.sqrt(dqk), **tkw)


def hstu_block_append(p: HSTUBlock, cfg: ArchConfig, x_new: torch.Tensor,
                      timestamps: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, rows: torch.Tensor,
                      prefix_len: torch.Tensor, total_len: torch.Tensor,
                      ninv: torch.Tensor, *,
                      time_mode: str = "bucket") -> torch.Tensor:
    """The warm-path HSTU block: encode only the appended window x_new
    (R, Q, d) of each slot row against the row's cached K/V. The window's
    K/V projections go into the layer's caches (N+1, cap, H, ·) at
    [p_r, p_r + Q) of slot ``rows[r]`` first (the caller keeps p_r + Q
    within the row). Causality leaves the prefix's hidden states as they
    were, so the window's outputs (R, Q, d) are the rows a full encode
    gives."""
    u, v_new, q_new, k_new = _hstu_uvqk(p, cfg, x_new)
    Q = x_new.shape[-2]
    r = rows.long()[:, None]
    at = prefix_len.long()[:, None] + torch.arange(Q, device=x_new.device)
    k_cache[r, at] = k_new
    v_cache[r, at] = v_new
    y = pointwise_attention_append(q_new, k_cache, v_cache, rows,
                                   timestamps, prefix_len, total_len, ninv,
                                   dict(p.rab.items()), cfg.rab,
                                   time_mode=time_mode)
    return _hstu_output(p, cfg, x_new, y, u)
