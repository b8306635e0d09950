"""The plain PyTorch versions of the negative-sampling kernels: the fused
kernels (K3, K4), with the same per-segment arithmetic as
``csrc/neg_fused.cu`` and the segment's rows materialised one segment at a
time, and the logits over materialised rows (K9, ``csrc/neg_logits.cu``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: Sentinel for masked (invalid-token) pool logits, as the reference's.
NEG_POOL = -1e30


def _segment_logits(o, src, ids_flat, s, segment, R, inv_tau, fetch_dtype):
    lo = s * segment
    rows = src[ids_flat[lo * R:(lo + segment) * R].long()]
    if fetch_dtype is not None:
        rows = rows.to(fetch_dtype)
    rows = rows.float().view(segment, R, -1)
    logits = torch.einsum("td,trd->tr", o[lo:lo + segment].float(),
                          rows) * inv_tau
    return rows, logits


def _share(logits, valid, perm_seg, expansion):
    """The shared logits of each expansion slot: (seg, R) each."""
    masked = torch.where(valid[:, None] > 0.0, logits,
                         torch.full_like(logits, NEG_POOL))
    return [masked[perm_seg[e].long()] for e in range(expansion - 1)]


def _lse(cols):
    alls = torch.cat(cols, dim=1)
    m = alls.max(dim=1, keepdim=True).values
    return m[:, 0] + torch.log(torch.exp(alls - m).sum(dim=1))


def neg_fwd_plain(o: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
                  ids_flat: torch.Tensor, valid: torch.Tensor,
                  perms: torch.Tensor, *, segment: int, R: int,
                  expansion: int, inv_tau: float,
                  fetch_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """K3: o (Tp, D), pos/valid (Tp,) fp32, src (V, D) rows, ids_flat
    (Tp·R,), perms (n_seg, E, segment) → lse (Tp,) fp32."""
    n_seg = o.shape[0] // segment
    out = []
    for s in range(n_seg):
        _, logits = _segment_logits(o, src, ids_flat, s, segment, R,
                                    inv_tau, fetch_dtype)
        seg = slice(s * segment, (s + 1) * segment)
        cols = [pos[seg, None], logits] + _share(logits, valid[seg],
                                                 perms[s], expansion)
        out.append(_lse(cols))
    return torch.cat(out)


def neg_bwd_plain(o: torch.Tensor, pos: torch.Tensor, src: torch.Tensor,
                  ids_flat: torch.Tensor, valid: torch.Tensor,
                  perms: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                  *, segment: int, R: int, expansion: int, inv_tau: float,
                  fetch_dtype: Optional[torch.dtype]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 → (w (Tp, R), dout (Tp, D), dpos (Tp,)), all fp32: the
    softmax weights times g with each shared slot's mass folded back onto
    its source row, and the grads of o and pos."""
    n_seg = o.shape[0] // segment
    ws, douts = [], []
    for s in range(n_seg):
        rows, logits = _segment_logits(o, src, ids_flat, s, segment, R,
                                       inv_tau, fetch_dtype)
        seg = slice(s * segment, (s + 1) * segment)
        gs, ls = g[seg, None], lse[seg, None]
        w = gs * torch.exp(logits - ls)
        for e, aux in enumerate(_share(logits, valid[seg], perms[s],
                                       expansion)):
            w = w.index_add(0, perms[s, e].long(), gs * torch.exp(aux - ls))
        ws.append(w)
        douts.append(((w[:, :, None] * rows) * inv_tau).sum(dim=1))
    dpos = g * torch.exp(pos - lse)
    return torch.cat(ws), torch.cat(douts), dpos


def neg_logits_fwd_plain(o: torch.Tensor, n: torch.Tensor, *,
                         inv_tau: float) -> torch.Tensor:
    """K9-fwd: o (T, D), n (T, R, D) → (T, R) fp32 (o·n)·1/τ in fp32."""
    return torch.einsum("td,trd->tr", o.float(), n.float()) * inv_tau


def neg_logits_bwd_plain(o: torch.Tensor, n: torch.Tensor, g: torch.Tensor,
                         *, inv_tau: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9-bwd: gs = g·1/τ first, as the reference's kernel takes it; do =
    Σ_r gs·n (T, D) fp32 and dn = gs·o rounded once to n's dtype."""
    gs = g.float() * inv_tau
    do = torch.einsum("tr,trd->td", gs, n.float())
    dn = (gs[:, :, None] * o.float()[:, None, :]).to(n.dtype)
    return do, dn


def neg_logits_ref(out_emb: torch.Tensor, neg_emb: torch.Tensor,
                   tau: float = 1.0) -> torch.Tensor:
    """The plain version of :func:`ops.neg_logits`'s forward (the
    reference's ``neg_logits_ref``): o·n in fp32, times 1/τ as the kernel
    takes it (the reference divides by τ: the same at τ = 1)."""
    return neg_logits_fwd_plain(out_emb, neg_emb, inv_tau=1.0 / tau)
