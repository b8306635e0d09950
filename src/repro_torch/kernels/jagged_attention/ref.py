"""The plain PyTorch versions of the jagged attention kernels.

:func:`attention_fwd_plain` (K1-fwd) and :func:`attention_bwd_plain` (K2)
take what the CUDA kernels take (q, k, v, the RAB tables and the plan) and
compute the same values by walking the plan's live (q-block, k-block)
pairs with dense per-pair einsums, a chunk of pairs at a time. They repeat
the kernels' arithmetic: scores and bias in fp32, the time bucket as
floor(log(1+dt)/denom) in fp32 or, with ``time_functional``, FuXi's
encoder amp·exp(−exp(ρ·ln z)), z = (float(|Δt|) + 1e-6)/σ, from the
packed (3, H) ``[amp; σ; ρ]`` in place of the time table; SiLU weights
scaled by 1/(pos+1) and, in the forward, rounded to v's dtype before the
a·v product; products accumulated in fp32. The wrapper uses them for CPU
tensors; ``chip_smoke.py`` holds the kernels against them on the card.

Both take an accumulation dtype, ``acc_dtype`` (float32 by default, the
kernels' arithmetic bit for bit). With float64 the scores, the bias
values, the SiLU weights, every product and every sum run in float64 on
the same inputs: the yardstick for an fp32 kernel whose sums are long
enough for their order to show (the RAB-table grads sum millions of
terms of both signs). The time bucket stays the fp32 integer function the
kernels and the reference define; only the table value it picks is
widened. The forward still rounds the SiLU weights to v's dtype.
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


def functional_terms(dt: torch.Tensor, tt: torch.Tensor):
    """FuXi's time encoder on |Δt| (…) int32 with ``tt`` the packed (3, H)
    [amp; σ; ρ] → (E, z^ρ, ln z), each (…, H) in tt's dtype (fp32 on the
    kernels' path), in the Pallas kernel's order of operations (z^ρ as
    exp(ρ·ln z)); the bias is amp·E. σ stays a tensor, so z is a true
    division on every device."""
    z = (dt.to(tt.dtype)[..., None] + 1e-6) / tt[1]
    lnz = torch.log(z)
    zr = torch.exp(tt[2] * lnz)
    return torch.exp(-zr), zr, lnz


def functional_grad_terms(E: torch.Tensor, zr: torch.Tensor,
                          lnz: torch.Tensor, tt: torch.Tensor):
    """∂bias/∂(amp, σ, ρ) per entry, (…, H) each: E, amp·E·ρ·z^ρ/σ and
    −amp·E·z^ρ·ln z, with the per-head factors amp·ρ/σ and −amp taken
    once. E·z^ρ is 0 where E underflows to 0 (z^ρ may be inf there), so a
    masked entry (ds = 0) adds exactly 0."""
    ezr = torch.where(E == 0, torch.zeros((), dtype=E.dtype,
                                          device=E.device), E * zr)
    c_sig = tt[0] * tt[2] / tt[1]
    c_rho = -tt[0]
    return E, ezr * c_sig, ezr * lnz * c_rho


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos_table: torch.Tensor, time_table: torch.Tensor,
                        plan, *, scale: float, tb_denom: float,
                        use_pos: bool, use_time: bool,
                        time_functional: bool = False,
                        acc_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """q, k, v (G, capp, H, D), a batched plan → (G, capp, H, D) v.dtype.
    q-blocks with no live pair come out zero. ``time_functional``: the
    time table is the packed (3, H) [amp; σ; ρ] of FuXi's encoder.
    ``acc_dtype``: the arithmetic's dtype (module docstring)."""
    G, capp, H, D = q.shape
    block = plan.block
    nb = capp // block
    npb, ntb = pos_table.shape[0], time_table.shape[0]
    dev = q.device
    ar = torch.arange(block, device=dev)
    pos_table, time_table = pos_table.to(acc_dtype), time_table.to(acc_dtype)
    out = torch.zeros((G, nb, block, H, D), dtype=acc_dtype, device=dev)
    for g in range(G):
        n = int(plan.n_live[g, 0])
        wl = plan.q_wl[g, :n].long()
        qg, kg, vg = (t[g].view(nb, block, H, D) for t in (q, k, v))
        seg = plan.meta_i32[g, :, 0].view(nb, block)
        ts = plan.meta_i32[g, :, 2].view(nb, block)
        ninv = plan.meta_f32[g, :, 0].view(nb, block).to(acc_dtype)
        for lo in range(0, n, PAIR_CHUNK):
            qb, kb = wl[lo:lo + PAIR_CHUNK, 0], wl[lo:lo + PAIR_CHUNK, 1]
            s = torch.einsum("pqhd,pkhd->pqkh", qg[qb].to(acc_dtype),
                             kg[kb].to(acc_dtype)) * scale
            qslot = qb[:, None] * block + ar                 # (P, bq)
            kslot = kb[:, None] * block + ar                 # (P, bk)
            bias = torch.zeros_like(s)
            if use_pos:
                d = (qslot[:, :, None] - kslot[:, None, :]).clamp(0, npb - 1)
                bias = bias + pos_table[d]
            if use_time:
                dt = (ts[qb][:, :, None] - ts[kb][:, None, :]).abs()
                if time_functional:
                    bias = bias + time_table[0] * functional_terms(
                        dt, time_table)[0]
                else:
                    bias = bias + time_table[time_buckets(dt, tb_denom,
                                                          ntb)]
            s = s + bias
            qseg, kseg = seg[qb], seg[kb]
            mask = ((qseg[:, :, None] == kseg[:, None, :])
                    & (qseg[:, :, None] >= 0)
                    & (qslot[:, :, None] >= kslot[:, None, :]))
            mw = mask.to(acc_dtype) * ninv[qb][:, :, None]
            a = (s * torch.sigmoid(s)) * mw[..., None]
            a = a.to(v.dtype).to(acc_dtype)
            out[g].index_add_(0, qb, torch.einsum("pqkh,pkhd->pqhd", a,
                                                  vg[kb].to(acc_dtype)))
    return out.view(G, capp, H, D).to(v.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dy: torch.Tensor, pos_table: torch.Tensor,
                        time_table: torch.Tensor, plan, *, scale: float,
                        tb_denom: float, use_pos: bool, use_time: bool,
                        time_functional: bool = False,
                        acc_dtype: torch.dtype = torch.float32):
    """The plain version of the backward kernels (K2): q, k, v, dy
    (G, capp, H, D), a batched plan → (dq, dk, dv) in q's dtype and the
    grads of ``pos_table`` (npb, H) and ``time_table`` (ntb, H) in
    ``acc_dtype`` (the arithmetic's dtype, module docstring; fp32 by
    default); with ``time_functional`` the latter is d(amp, σ, ρ) (3, H),
    summed per entry as :func:`functional_grad_terms` gives them.

    Per live pair it recomputes s and, like the TPU kernel, keeps the
    SiLU weights a in fp32 for dv (the forward's rounding of a to v's
    dtype passes the gradient straight through):
    da = dy·vᵀ, ds = da·SiLU′(s)·mask/(pos+1); dv += aᵀ·dy,
    dk += dsᵀ·q·scale, dq += ds·k·scale; the RAB grads sum ds per bucket.
    """
    G, capp, H, D = q.shape
    block = plan.block
    nb = capp // block
    npb, ntb = pos_table.shape[0], time_table.shape[0]
    dev = q.device
    ar = torch.arange(block, device=dev)
    pos_table, time_table = pos_table.to(acc_dtype), time_table.to(acc_dtype)
    dq = torch.zeros((G, nb, block, H, D), dtype=acc_dtype, device=dev)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    dpt = torch.zeros((npb, H), dtype=acc_dtype, device=dev)
    dtt = torch.zeros((ntb, H), dtype=acc_dtype, device=dev)
    for g in range(G):
        n = int(plan.n_live[g, 0])
        wl = plan.q_wl[g, :n].long()
        qg, kg, vg, dyg = (t[g].view(nb, block, H, D).to(acc_dtype)
                           for t in (q, k, v, dy))
        seg = plan.meta_i32[g, :, 0].view(nb, block)
        ts = plan.meta_i32[g, :, 2].view(nb, block)
        ninv = plan.meta_f32[g, :, 0].view(nb, block).to(acc_dtype)
        for lo in range(0, n, PAIR_CHUNK):
            qb, kb = wl[lo:lo + PAIR_CHUNK, 0], wl[lo:lo + PAIR_CHUNK, 1]
            s = torch.einsum("pqhd,pkhd->pqkh", qg[qb], kg[kb]) * scale
            qslot = qb[:, None] * block + ar
            kslot = kb[:, None] * block + ar
            d = (qslot[:, :, None] - kslot[:, None, :]).clamp(0, npb - 1)
            bias = torch.zeros_like(s)
            if use_pos:
                bias = bias + pos_table[d]
            if use_time:
                dt = (ts[qb][:, :, None] - ts[kb][:, None, :]).abs()
                if time_functional:
                    terms = functional_terms(dt, time_table)
                    bias = bias + time_table[0] * terms[0]
                else:
                    tb = time_buckets(dt, tb_denom, ntb)
                    bias = bias + time_table[tb]
            s = s + bias
            qseg, kseg = seg[qb], seg[kb]
            mask = ((qseg[:, :, None] == kseg[:, None, :])
                    & (qseg[:, :, None] >= 0)
                    & (qslot[:, :, None] >= kslot[:, None, :]))
            mw = (mask.to(acc_dtype) * ninv[qb][:, :, None])[..., None]
            sig = torch.sigmoid(s)
            a = s * sig * mw
            da = torch.einsum("pqhd,pkhd->pqkh", dyg[qb], vg[kb])
            ds = da * (sig * (1.0 + s * (1.0 - sig))) * mw
            dv[g].index_add_(0, kb, torch.einsum("pqkh,pqhd->pkhd", a,
                                                 dyg[qb]))
            dk[g].index_add_(0, kb, torch.einsum("pqkh,pqhd->pkhd", ds,
                                                 qg[qb]) * scale)
            dq[g].index_add_(0, qb, torch.einsum("pqkh,pkhd->pqhd", ds,
                                                 kg[kb]) * scale)
            if use_pos:
                dpt.index_add_(0, d.reshape(-1), ds.reshape(-1, H))
            if use_time and time_functional:
                for t, g_t in enumerate(functional_grad_terms(*terms,
                                                              time_table)):
                    dtt[t] += (ds * g_t).sum((0, 1, 2))
            elif use_time:
                dtt.index_add_(0, tb.reshape(-1), ds.reshape(-1, H))
    shape = (G, capp, H, D)
    return (dq.view(shape).to(q.dtype), dk.view(shape).to(q.dtype),
            dv.view(shape).to(q.dtype), dpt, dtt)


def attention_append_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, rows: torch.Tensor,
                           timestamps: torch.Tensor,
                           prefix_len: torch.Tensor, total_len: torch.Tensor,
                           pos_table: torch.Tensor, time_table: torch.Tensor,
                           ninv: torch.Tensor, *, block: int, scale: float,
                           tb_denom: float, use_pos: bool, use_time: bool,
                           time_functional: bool = False,
                           acc_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The plain version of K1-fwd's append launch: the warm window's
    queries q (R, Q, H, D) at rows [p_r, p_r + Q) of slot row
    ``rows[r]`` against that row's cached keys (N+1, cap, H, D)
    → (R, Q, H, D) v's dtype.

    ``timestamps`` (R, cap) are the rows' timestamps, ``prefix_len`` p_r
    and ``total_len`` T_r = p_r + n_r (R,) int, ``ninv`` (cap,) the
    1/(pos+1) the launch reads, which must equal the cold plan's (checked).
    Each row runs as the cold launch's pack of that row alone: the
    window's queries at their rows and zeros elsewhere, the row's cache as
    K and V, the plan of offsets [0, T_r]; :func:`attention_fwd_plain`
    walks that plan and the window's rows are cut out. So a live query
    gets the bits of the cold plain version on its row, and window rows at
    or past T_r come out 0."""
    from repro_torch.kernels.jagged_attention import ops
    R, Q = q.shape[:2]
    cap = k_cache.shape[1]
    out = torch.zeros(q.shape, dtype=v_cache.dtype, device=q.device)
    for r in range(R):
        p, T, slot = int(prefix_len[r]), int(total_len[r]), int(rows[r])
        n = min(Q, cap - p)
        qr = q.new_zeros(k_cache.shape[1:])
        qr[p:p + n] = q[r, :n]
        offs = torch.tensor([0, T], dtype=torch.int32, device=q.device)
        plan = ops._as_batched(ops.build_attn_plan(offs, timestamps[r], cap,
                                                   block=block))
        if not torch.equal(plan.meta_f32[0, :T, 0], ninv[:T]):
            raise ValueError("ninv differs from the cold plan's 1/(pos+1)")
        y = attention_fwd_plain(
            qr[None], k_cache[slot][None], v_cache[slot][None], pos_table,
            time_table, plan, scale=scale, tb_denom=tb_denom,
            use_pos=use_pos, use_time=use_time,
            time_functional=time_functional, acc_dtype=acc_dtype)
        out[r, :n] = y[0, p:p + n]
    return out


def jagged_attention_ref(q, k, v, offsets, timestamps, rab_params, rab, *,
                         time_mode: str = "bucket", block: int = 128,
                         plan=None, schedule: str = "worklist",
                         max_row_len: Optional[int] = None) -> torch.Tensor:
    """``ops.jagged_attention`` with the plain version in place of the
    kernel, on any device: what a check calls to recompute a kernel result
    explicitly. The plain version serves both schedules (K1/K2 and K8
    compute one function)."""
    from repro_torch.kernels.jagged_attention import ops
    return ops.run_attention(q, k, v, offsets, timestamps, rab_params, rab,
                             core=ops.plain_core, time_mode=time_mode,
                             block=block, plan=plan, schedule=schedule,
                             max_row_len=max_row_len)


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
