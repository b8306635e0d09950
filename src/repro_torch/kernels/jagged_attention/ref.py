"""The plain PyTorch version of the jagged attention forward kernel.

:func:`attention_fwd_plain` takes what the CUDA kernel takes (q, k, v, the
RAB tables and the plan) and computes the same values by walking the
plan's live (q-block, k-block) pairs with dense per-pair einsums, a chunk
of pairs at a time. It repeats the kernel's arithmetic: scores and bias in
fp32, the time bucket as floor(log(1+dt)/denom) in fp32, SiLU weights
scaled by 1/(pos+1) and rounded to v's dtype before the a·v product, the
product accumulated in fp32. The wrapper uses it for CPU tensors;
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

#: Live pairs per einsum: bounds the (pairs, block, block, H) fp32 scores.
PAIR_CHUNK = 32


def time_buckets(dt: torch.Tensor, tb_denom: float,
                 num_buckets: int) -> torch.Tensor:
    """floor(log(1+dt) / denom) in fp32, clipped: the kernel's bucket. The
    divisor is a tensor on dt's device: PyTorch divides a CUDA tensor by a
    Python scalar as a multiply by its reciprocal, which moves a quotient
    within an ulp below an integer into the bucket under it."""
    denom = torch.tensor(tb_denom, dtype=torch.float32, device=dt.device)
    tb = torch.floor(torch.log(1.0 + dt.to(torch.float32)) / denom)
    return tb.long().clamp(0, num_buckets - 1)


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos_table: torch.Tensor, time_table: torch.Tensor,
                        plan, *, scale: float, tb_denom: float,
                        use_pos: bool, use_time: bool) -> torch.Tensor:
    """q, k, v (G, capp, H, D), a batched plan → (G, capp, H, D) v.dtype.
    q-blocks with no live pair come out zero."""
    G, capp, H, D = q.shape
    block = plan.block
    nb = capp // block
    npb, ntb = pos_table.shape[0], time_table.shape[0]
    dev = q.device
    ar = torch.arange(block, device=dev)
    out = torch.zeros((G, nb, block, H, D), dtype=torch.float32, device=dev)
    for g in range(G):
        n = int(plan.n_live[g, 0])
        wl = plan.q_wl[g, :n].long()
        qg, kg, vg = (t[g].view(nb, block, H, D) for t in (q, k, v))
        seg = plan.meta_i32[g, :, 0].view(nb, block)
        ts = plan.meta_i32[g, :, 2].view(nb, block)
        ninv = plan.meta_f32[g, :, 0].view(nb, block)
        for lo in range(0, n, PAIR_CHUNK):
            qb, kb = wl[lo:lo + PAIR_CHUNK, 0], wl[lo:lo + PAIR_CHUNK, 1]
            s = torch.einsum("pqhd,pkhd->pqkh", qg[qb].float(),
                             kg[kb].float()) * scale
            qslot = qb[:, None] * block + ar                 # (P, bq)
            kslot = kb[:, None] * block + ar                 # (P, bk)
            bias = torch.zeros_like(s)
            if use_pos:
                d = (qslot[:, :, None] - kslot[:, None, :]).clamp(0, npb - 1)
                bias = bias + pos_table[d]
            if use_time:
                dt = (ts[qb][:, :, None] - ts[kb][:, None, :]).abs()
                bias = bias + time_table[time_buckets(dt, tb_denom, ntb)]
            s = s + bias
            qseg, kseg = seg[qb], seg[kb]
            mask = ((qseg[:, :, None] == kseg[:, None, :])
                    & (qseg[:, :, None] >= 0)
                    & (qslot[:, :, None] >= kslot[:, None, :]))
            mw = mask.float() * ninv[qb][:, :, None]
            a = (s * torch.sigmoid(s)) * mw[..., None]
            a = a.to(v.dtype).float()
            out[g].index_add_(0, qb, torch.einsum("pqkh,pkhd->pqhd", a,
                                                  vg[kb].float()))
    return out.view(G, capp, H, D).to(v.dtype)


def jagged_attention_ref(q, k, v, offsets, timestamps, rab_params, rab, *,
                         time_mode: str = "bucket", block: int = 128,
                         plan=None,
                         max_row_len: Optional[int] = None) -> torch.Tensor:
    """``ops.jagged_attention`` with the plain version in place of the
    kernel, on any device: what a check calls to recompute a kernel result
    explicitly."""
    from repro_torch.kernels.jagged_attention import ops
    return ops.run_attention(q, k, v, offsets, timestamps, rab_params, rab,
                             core=attention_fwd_plain, time_mode=time_mode,
                             block=block, plan=plan, max_row_len=max_row_len)


def max_row_rel_err(out: torch.Tensor, plain: torch.Tensor) -> float:
    """max over (token, head) of |out - plain|₂ / |plain|₂ along the head
    dim: how a bf16 result is held against the plain version. A one-ulp
    bf16 flip is relative to the value it hits, and outputs of long rows
    are small (the 1/(pos+1) weights), so an absolute limit set by short
    rows could not see a long row lose a k-block; this limit can. A row
    that is zero in the plain version must be zero in ``out``."""
    o, p = out.float(), plain.float()
    num = (o - p).norm(dim=-1)
    den = p.norm(dim=-1)
    rel = torch.where(den > 0, num / den.clamp(min=1e-30),
                      torch.where(num > 0, torch.inf, 0.0))
    return rel.max().item()
