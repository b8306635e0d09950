"""Mamba-2 (SSD, state-space duality) block in chunked matmul form (the
port of ``repro.models.mamba``).

Within a chunk the computation is attention-like (batched matmuls); across
chunks a short loop carries the chunk states. ``seg`` resets the
recurrence at segment boundaries (jagged packing): the decay across a
boundary is made total by writing −1e9 into dt·A there, the reference's
arithmetic.

The reference's products are fp32 (``preferred_element_type``); here each
goes through :func:`~repro_torch.models.layers.matmul_f32`. Its three
four-operand einsums are written as explicit pairwise steps: the
elementwise factors are applied first, then one batched matmul contracts
the rest. Left to ``torch.einsum`` the contraction order is free, and one
order builds a (b, nc, H, c, c, P) intermediate: at ``mamba2-2.7b`` with
one 4096-token sequence that is 16 × 80 × 256² × 64 × 4 B ≈ 21 GB in one
layer. The C·B scores are the same for every head of a group of B/C:
they are computed once per group and broadcast.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.core.sharding import (constrain, logical_axis_size,
                                      per_shard)
from repro_torch.models.layers import (_const, _normal, matmul_f32,
                                       whole_sequence)


class Mamba(nn.Module):
    """``init_mamba``'s parameters: separate ``in_z``, ``in_x`` (d, d_in),
    ``in_bc`` (d, 2·G·N), ``in_dt`` (d, H) at 1/√d; ``out_proj`` (d_in, d)
    at 1/√(d_in·2·L); ``conv_w`` (K, d_in + 2·G·N) at 0.1, ``conv_b`` zero;
    ``A_log`` = log(linspace(1, 16, H)), ``D`` ones, ``dt_bias`` uniform in
    [log 1e-3, log 1e-1] (all three fp32); ``norm_w`` ones."""

    def __init__(self, cfg: ArchConfig, *, dtype, device, generator=None):
        super().__init__()
        s: SSMConfig = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d
        H = d_in // s.head_dim
        d_bc = s.n_groups * s.d_state
        self.in_z = _normal((d, d_in), 1 / math.sqrt(d), dtype, device,
                            generator)
        self.in_x = _normal((d, d_in), 1 / math.sqrt(d), dtype, device,
                            generator)
        self.in_bc = _normal((d, 2 * d_bc), 1 / math.sqrt(d), dtype, device,
                             generator)
        self.in_dt = _normal((d, H), 1 / math.sqrt(d), dtype, device,
                             generator)
        self.out_proj = _normal((d_in, d),
                                1 / math.sqrt(d_in * 2 * cfg.num_layers),
                                dtype, device, generator)
        self.conv_w = _normal((s.conv_width, d_in + 2 * d_bc), 0.1, dtype,
                              device, generator)
        self.conv_b = _const((d_in + 2 * d_bc,), 0.0, dtype, device)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=torch.float32, device=device)))
        self.D = _const((H,), 1.0, torch.float32, device)
        u = torch.rand(H, dtype=torch.float32, device=device,
                       generator=generator)
        lo, hi = math.log(1e-3), math.log(1e-1)
        self.dt_bias = nn.Parameter(lo + (hi - lo) * u)
        self.norm_w = _const((d_in,), 1.0, dtype, device)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum x[..., j+1:i+1], −inf for
    j > i."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _by_head(t: torch.Tensor, H: int) -> torch.Tensor:
    """(b, nc, G, ...) → (b, nc, H, ...): each group's slice for its H/G
    heads (the reference's ``jnp.repeat`` over the head axis; with one
    group a broadcast view)."""
    G = t.shape[2]
    if G == H:
        return t
    if G == 1:
        return t.expand(*t.shape[:2], H, *t.shape[3:])
    return torch.repeat_interleave(t, H // G, dim=2)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                seg: Optional[torch.Tensor] = None,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: (b, S, H, P), dt: (b, S, H), A: (H,), B/C: (b, S, G, N).

    Returns (y (b, S, H, P) in x's dtype, final state (b, H, P, N) fp32).
    ``seg`` (b, S) int resets the state at segment boundaries."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk

    dtA = dt * A[None, None, :]                                  # ≤ 0
    if seg is not None:
        # where seg[t] != seg[t-1] the decay t-1 → t is made total
        boundary = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                          device=x.device),
                              seg[:, 1:] != seg[:, :-1]], dim=1)
        dtA = torch.where(boundary[..., None],
                          torch.tensor(-1e9, dtype=dtA.dtype,
                                       device=dtA.device), dtA)

    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)
    dtAc = dtA.reshape(b, nc, chunk, H)
    Bg = Bm.reshape(b, nc, chunk, G, N).permute(0, 1, 3, 2, 4)   # (b,z,G,c,N)
    Cg = Cm.reshape(b, nc, chunk, G, N).permute(0, 1, 3, 2, 4)

    Acs = torch.cumsum(dtAc, dim=2)                              # (b,z,c,H)
    # x·dt, the factor both sums below carry per position
    xdt = (xc.float() * dtc[..., None]).permute(0, 1, 3, 2, 4)   # (b,z,H,c,P)
    # 1. diagonal (within-chunk) term:
    #    y[c,h,p] = Σ_s (C_c·B_s)[h] · L[h,c,s] · (dt·x)[s,h,p]
    Lmat = torch.exp(_segsum(dtAc.permute(0, 1, 3, 2)))          # (b,z,H,c,c)
    scores = _by_head(matmul_f32(Cg, Bg.transpose(-1, -2)), H)  # (b,z,H,c,c)
    y_diag = matmul_f32(scores * Lmat, xdt)                      # (b,z,H,c,P)

    # 2. per-chunk output states: st[h,p,n] = Σ_c (dt·x)[c,h,p]·decay[c,h]·B[c,n]
    decay_states = torch.exp(Acs[:, :, -1:, :] - Acs)            # (b,z,c,H)
    xw = xdt * decay_states.permute(0, 1, 3, 2)[..., None]       # (b,z,H,c,P)
    states = matmul_f32(xw.transpose(-1, -2),                    # (b,z,H,P,c)
                        _by_head(Bg, H))                         # (b,z,H,P,N)

    # 3. cross-chunk recurrence (a short loop over nc)
    chunk_decay = torch.exp(Acs[:, :, -1, :])                    # (b,z,H)
    h = (init_state if init_state is not None
         else torch.zeros((b, H, P, N), dtype=torch.float32,
                          device=x.device))
    h_in = []
    for z in range(nc):
        h_in.append(h)                                           # entering z
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_final = h
    h_in = torch.stack(h_in, dim=1)                              # (b,z,H,P,N)

    # 4. state → output: y[c,h,p] = Σ_n C[c,n]·exp(Acs[c,h])·h_in[h,p,n]
    state_decay = torch.exp(Acs).permute(0, 1, 3, 2)             # (b,z,H,c)
    Cw = _by_head(Cg, H) * state_decay[..., None]                # (b,z,H,c,N)
    y_off = matmul_f32(Cw, h_in.transpose(-1, -2))               # (b,z,H,c,P)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, S, H, P)
    return y.to(x.dtype), h_final


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """Single-token recurrent update. x: (b, 1, H, P), dt: (b, 1, H),
    B/C: (b, 1, G, N), state (b, H, P, N) fp32."""
    b, _, H, P = x.shape
    G = Bm.shape[2]
    rep = H // G
    Bh = torch.repeat_interleave(Bm[:, 0], rep, dim=1)           # (b,H,N)
    Ch = torch.repeat_interleave(Cm[:, 0], rep, dim=1)
    dtA = torch.exp(dt[:, 0] * A[None, :])                       # (b,H)
    # upd[h,p,n] = B[h,n]·dt[h]·x[h,p]: the elementwise factors, then the
    # outer product
    xdt = x[:, 0].float() * dt[:, 0, :, None]                    # (b,H,P)
    upd = matmul_f32(xdt[..., None], Bh.float()[:, :, None, :])  # (b,H,P,N)
    state = state * dtA[:, :, None, None] + upd
    y = matmul_f32(state, Ch[..., None]).squeeze(-1)             # (b,H,P)
    return y[:, None].to(x.dtype), state


def _causal_conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d + SiLU. h: (B, S, C), w: (K, C). Returns
    (out, new_state): the last K−1 inputs, for decode."""
    K = w.shape[0]
    if conv_state is not None:                                   # decode
        buf = torch.cat([conv_state, h], dim=1)                  # (B,K,C)
        out = (buf.float() * w.float()).sum(dim=1).to(h.dtype) + b
        return F.silu(out)[:, None], buf[:, 1:]
    pad = torch.zeros((h.shape[0], K - 1, h.shape[2]), dtype=h.dtype,
                      device=h.device)
    hp = torch.cat([pad, h], dim=1)
    S = h.shape[1]
    out = hp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + hp[:, i:i + S] * w[i]
    out = out + b
    new_state = hp[:, -(K - 1):] if K > 1 else None
    return F.silu(out), new_state


def mamba_block(p: Mamba, cfg: ArchConfig, x: torch.Tensor, *,
                seg: Optional[torch.Tensor] = None,
                state: Optional[Dict[str, torch.Tensor]] = None):
    """Full Mamba-2 block. x: (B, S, d). Returns (out, new_state), state =
    {"ssm": (B, H, P, N) fp32, "conv": (B, K−1, C)}. One token with a state
    is a decode step; otherwise the chunked scan (seeded by the state's
    "ssm" if given) over S padded to a whole chunk with dt = 0 tokens
    (decay 1, no contribution: the final state is untouched)."""
    s: SSMConfig = cfg.ssm
    B, S, d = x.shape
    d_in = s.expand * d
    d_bc = s.n_groups * s.d_state
    H = d_in // s.head_dim

    x = whole_sequence(x)
    z = x @ p.in_z
    xbc = torch.cat([x @ p.in_x, x @ p.in_bc], dim=-1)
    dtr = x @ p.in_dt
    z = constrain(z, "batch", None, "tp")
    decode = state is not None and S == 1
    conv_state = state["conv"] if decode else None
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xs, Bm, Cm = torch.split(xbc, [d_in, d_bc, d_bc], dim=-1)

    dt = F.softplus(dtr.float() + p.dt_bias)                     # (B,S,H)
    A = -torch.exp(p.A_log)
    xh = constrain(xs.reshape(B, S, H, s.head_dim), "batch", None, "tp",
                   None)
    Bm = Bm.reshape(B, S, s.n_groups, s.d_state).float()
    Cm = Cm.reshape(B, S, s.n_groups, s.d_state).float()

    # the scan is independent across samples and heads: over a mesh each
    # device runs its shard (B/C have one group, whole on every device)
    assert s.n_groups == 1 or logical_axis_size("tp") == 1, \
        "B/C groups split with the heads are not laid out"
    heads = ("batch", None, "tp", None)                         # x, y
    ssm = ("batch", "tp", None, None)                            # state
    bc = ("batch", None, None, None)
    dims = (heads, ("batch", None, "tp"), ("tp",), bc, bc)       # x dt A B C
    if decode:
        y, new_ssm = per_shard(
            ssd_decode_step, (xh, dt, A, Bm, Cm, state["ssm"]),
            dims + (ssm,), (heads, ssm))
    else:
        chunk = min(s.chunk, S)
        pad = (-S) % chunk
        xq = xh
        if pad:
            xq = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
            if seg is not None:
                seg = F.pad(seg, (0, pad), value=-1)
        init = state["ssm"] if state is not None else None
        def scan(x_, dt_, A_, B_, C_, seg_, h0):
            return ssd_chunked(x_, dt_, A_, B_, C_, chunk, seg=seg_,
                               init_state=h0)

        y, new_ssm = per_shard(scan, (xq, dt, A, Bm, Cm, seg, init),
                               dims + (("batch", None), ssm), (heads, ssm))
        if pad:
            y = y[:, :S]
        if state is not None and new_conv is None:
            new_conv = state["conv"]

    in_dtype = x.dtype
    y = y + xh * p.D[None, None, :, None].to(y.dtype)            # D skip
    y = y.reshape(B, S, d_in)
    # gated RMSNorm (Mamba-2)
    y = y * F.silu(z).to(y.dtype)
    y32 = y.float()
    y = (y32 * torch.rsqrt(torch.mean(y32 * y32, -1, keepdim=True) + 1e-5)
         * p.norm_w.float()).to(in_dtype)
    out = y @ p.out_proj
    new_state = ({"ssm": new_ssm, "conv": new_conv} if new_conv is not None
                 else {"ssm": new_ssm})
    return out, new_state


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    d_bc = s.n_groups * s.d_state
    return {
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_in + 2 * d_bc),
                            dtype=dtype, device=device),
    }
