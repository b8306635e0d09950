"""Negative-sampling recall loss (paper §4.3), the port's training path.

:func:`fused_sampled_softmax_loss` is Eq. 2 straight from ids through the
fused kernels (``repro_torch.kernels.neg_logits``): the negative rows are
gathered from the half-precision shadow inside K3/K4, and the table
gradient leaves as sparse (id, row) pairs (a ``TableGradSink``) or, when
the table requires grad, as a dense grad at test sizes.
:func:`sampled_softmax_loss` is Eq. 2 over given logits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.neg_logits import (NEG_POOL, TableGradSink,
                                            fused_recall_lse)

__all__ = ["NEG_POOL", "fused_sampled_softmax_loss", "sampled_softmax_loss"]


def _masked_mean(nll: torch.Tensor, valid: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if valid is None:
        return nll.mean()
    v = valid.to(torch.float32)
    return (nll * v).sum() / v.sum().clamp(min=1.0)


def sampled_softmax_loss(pos_logit: torch.Tensor, neg_logits: torch.Tensor,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Loss = −log(e^{l⁺} / (e^{l⁺} + Σ_j e^{l⁻_j} + Δ)) (paper Eq. 2):
    pos_logit (T,), neg_logits (T, R′) (shared logits included), valid
    (T,) mask → the mean over valid tokens."""
    all_logits = torch.cat([pos_logit[:, None], neg_logits], dim=-1)
    lse = torch.logsumexp(all_logits.float(), dim=-1)
    return _masked_mean(lse - pos_logit.float(), valid)


def fused_sampled_softmax_loss(out_emb: torch.Tensor, pos_emb: torch.Tensor,
                               table: torch.Tensor, neg_ids: torch.Tensor, *,
                               perms: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               tau: float = 1.0,
                               valid: Optional[torch.Tensor] = None,
                               segment: int = 128, expansion: int = 1,
                               fetch_dtype=torch.float16,
                               shadow: Optional[torch.Tensor] = None,
                               scatter_impl: str = "fused",
                               table_grad_pairs: Optional[TableGradSink] = None
                               ) -> torch.Tensor:
    """Eq. 2 from ids: out_emb (T, D), pos_emb (T, D) label rows, table
    (V, D) fp32 master, neg_ids (T, R). ``shadow`` is the half-precision
    table the negatives are read from (else ``fetch_dtype`` rounds master
    rows). ``perms``/``generator``: the §4.3.3 sharing shuffle (see
    ``make_share_perms``). ``scatter_impl`` must be ``"two_pass"`` until
    K5 is ported."""
    pos = (out_emb.float() * pos_emb.float()).sum(-1) / tau
    lse = fused_recall_lse(out_emb, pos, table, neg_ids, segment=segment,
                           tau=tau, expansion=expansion, perms=perms,
                           generator=generator, valid=valid,
                           fetch_dtype=fetch_dtype, gather_table=shadow,
                           scatter_impl=scatter_impl,
                           table_grad_pairs=table_grad_pairs)
    return _masked_mean(lse - pos, valid)
