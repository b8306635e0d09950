"""SASRec block (the paper's Appendix-A baseline; Kang & McAuley 2018):
LN → causal softmax attention → residual → LN → pointwise FFN (d → d,
ReLU) → residual, over the packed jagged layout with a same-row causal
mask, so it drops into the GR stack beside HSTU and FuXi. No RAB: SASRec
is time-agnostic, and ``timestamps``/``plan`` are taken and unused.

No TPU kernel computes this attention (the JAX package inlines it), so
plain PyTorch is the port: fp32 scores, the mask, softmax over the keys,
the NaN rows of keyless (padding) queries set to 0, then a·v with a in
v's dtype and fp32 accumulation. The queries go a chunk at a time
(:data:`SCORE_ELEMS`), each chunk against the keys up to its last query
(the rest are masked), so the fp32 scores of a call never exceed
SCORE_ELEMS elements: at RecallEngine's 2 × 8192-token packs a chunk is
256 queries, 128 MB of scores, where one (cap, cap, H) block would be
2.1 GB per pack and layer.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.jagged import segment_ids
from repro_torch.models.hstu import _block_norm

#: fp32 score elements per query chunk (G · chunk · keys · H ≤ this).
SCORE_ELEMS = 1 << 25


class SASRecBlock(nn.Module):
    """One SASRec block's parameters, laid out as the JAX package's pytree
    (``init_sasrec_block``'s scales): ``w_qkv`` (d, 3·H·hd) splits in q, k,
    v order; ``w_o`` (H·hd, d); the FFN's ``ffn_w1``/``ffn_b1``,
    ``ffn_w2``/``ffn_b2``; the norms ``ln1_*``/``ln2_*``. ``rab`` is empty
    (the GR stack's blocks share that attribute)."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        hd = cfg.qkv_dim or (d // H)

        def normal(*shape):
            return torch.randn(*shape, dtype=torch.float32, device=device,
                               generator=generator)

        def const(fill):
            return nn.Parameter(torch.full((d,), fill, dtype=dtype,
                                           device=device))

        L2 = 2 * cfg.num_layers
        self.ln1_w, self.ln1_b = const(1.0), const(0.0)
        self.ln2_w, self.ln2_b = const(1.0), const(0.0)
        self.w_qkv = nn.Parameter((normal(d, 3 * H * hd)
                                   / math.sqrt(d)).to(dtype))
        self.w_o = nn.Parameter((normal(H * hd, d)
                                 / math.sqrt(H * hd * L2)).to(dtype))
        self.ffn_w1 = nn.Parameter((normal(d, d) / math.sqrt(d)).to(dtype))
        self.ffn_b1 = const(0.0)
        self.ffn_w2 = nn.Parameter((normal(d, d)
                                    / math.sqrt(d * L2)).to(dtype))
        self.ffn_b2 = const(0.0)
        self.rab = nn.ParameterDict()


def causal_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             offsets: torch.Tensor) -> torch.Tensor:
    """Same-row causal softmax attention over packed tokens: q, k, v
    (…, cap, H, hd) with offsets (…, S+1) → (…, cap, H, hd) in v's dtype.
    Queries with no key (padding) come out exactly 0."""
    cap, H, hd = q.shape[-3:]
    lead = q.shape[:-3]
    G = math.prod(lead)
    seg = segment_ids(offsets, cap)
    slot = torch.arange(cap, device=q.device)
    # queries past every pack's last token have no key: they stay 0 (on
    # meta, shapes only: every slot live)
    if q.device.type == "meta":
        n_live = cap
    else:
        n_live = int(offsets[..., -1].max()) if offsets.numel() else 0
    chunk = max(1, SCORE_ELEMS // max(1, G * cap * H))
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    for c0 in range(0, n_live, chunk):
        c1 = min(c0 + chunk, n_live)
        s = torch.einsum("...qhd,...khd->...qkh", q[..., c0:c1, :, :].float(),
                         k[..., :c1, :, :].float()) * scale
        qs, ks = seg[..., c0:c1], seg[..., :c1]
        mask = ((qs[..., :, None] == ks[..., None, :])
                & (qs[..., :, None] >= 0)
                & (slot[c0:c1, None] >= slot[None, :c1]))
        s = torch.where(mask[..., None], s, float("-inf"))
        a = torch.softmax(s, dim=-2)
        a = torch.where(torch.isnan(a), 0.0, a)      # rows with no key
        y = torch.einsum("...qkh,...khd->...qhd", a.to(v.dtype).float(),
                         v[..., :c1, :, :].float())
        out[..., c0:c1, :, :] = y.to(v.dtype)
    return out


def sasrec_block(p: SASRecBlock, cfg: ArchConfig, x: torch.Tensor,
                 offsets: torch.Tensor, timestamps: torch.Tensor, *,
                 attn_fn=None, time_mode: str = "none",
                 plan=None) -> torch.Tensor:
    """One SASRec block over packed tokens x (cap, d) or (G, cap, d)."""
    del timestamps, attn_fn, time_mode, plan       # time-agnostic, inlined
    H = cfg.num_heads
    hd = cfg.qkv_dim or (cfg.d_model // H)
    lead = x.shape[:-1]
    h = _block_norm(x, p.ln1_w, p.ln1_b, cfg.norm_eps)
    q, k, v = torch.split(h @ p.w_qkv, H * hd, dim=-1)
    q, k, v = (t.reshape(*lead, H, hd) for t in (q, k, v))
    y = causal_softmax_attention(q, k, v, offsets)
    x = x + y.reshape(*lead, H * hd) @ p.w_o
    h = _block_norm(x, p.ln2_w, p.ln2_b, cfg.norm_eps)
    ff = torch.relu(h @ p.ffn_w1 + p.ffn_b1) @ p.ffn_w2 + p.ffn_b2
    return x + ff
