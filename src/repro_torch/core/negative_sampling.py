"""Negative-sampling recall loss (paper §4.3), the port's training path.

:func:`fused_sampled_softmax_loss` (:func:`fused_recall_loss` from the
positive logits) is Eq. 2 straight from ids through the fused kernels
(``repro_torch.kernels.neg_logits``): the negative rows are gathered from
the half-precision shadow inside K3/K4, and the table
gradient leaves as sparse (id, row) pairs (a ``TableGradSink``) or, when
the table requires grad, as a dense grad at test sizes; K5 reduces the
pairs without building the negative rows (``scatter_impl="fused"``).

The §4.3 / Table-7 ablation's other paths compute the (T, R) negative
logits first: :func:`neg_logits_baseline` over a materialised (T, R, D)
tensor, :func:`neg_logits_segmented` fetching fp16 rows one segment of
tokens at a time (§4.3.1 + §4.3.2), and :func:`neg_logits_offloaded` over
rows held in pinned host memory (:func:`offload_negatives`), streamed to
the card a segment at a time (``core/offload.py``). Both run K9 (``csrc/neg_logits.cu``)
on the card, the reference's baseline an XLA einsum of the same function
(a declared divergence), and both can hand their rows' table grad to a
``TableGradSink`` in its rows form. :func:`share_logits` (§4.3.3) widens
the logits by other tokens' logits; :func:`recall_loss` and
:func:`sampled_softmax_loss` are Eq. 2 over given logits.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.offload import neg_logits_offloaded, offload_negatives
from repro_torch.kernels.neg_logits import (NEG_POOL, ShareLayout,
                                            TableGradSink, fused_recall_lse,
                                            neg_logits, neg_logits_bwd,
                                            neg_logits_fwd)

__all__ = ["NEG_POOL", "fused_recall_loss", "fused_sampled_softmax_loss",
           "neg_logits_baseline", "neg_logits_offloaded",
           "neg_logits_segmented", "offload_negatives", "positive_logits",
           "recall_loss", "sample_negative_ids", "sampled_softmax_loss",
           "share_logits"]


def sample_negative_ids(generator: Optional[torch.Generator], *,
                        num_tokens: int, num_negatives: int, vocab_size: int,
                        device=None) -> torch.Tensor:
    """Uniform negative ids (T, R) int32 in [0, vocab), from ``generator``
    (the reference draws from a jax key). The caller passes only valid
    token slots (the packed layout), so padding never gets negatives."""
    return torch.randint(0, vocab_size, (num_tokens, num_negatives),
                         generator=generator, device=device,
                         dtype=torch.int32)


def neg_logits_baseline(out_emb: torch.Tensor, neg_emb: torch.Tensor,
                        tau: float = 1.0, *,
                        on_neg_grad: Optional[Callable] = None
                        ) -> torch.Tensor:
    """The materialised path, out (T, D) × neg (T, R, D) → (T, R) fp32:
    K9 on the card, its plain version on the CPU (the reference's XLA
    einsum, o·n in fp32 over τ; the kernel multiplies by 1/τ, the same at
    τ = 1). The (T, R, D) input is the device-memory hog the paper
    offloads; kept as the faithful baseline of Table 7. ``on_neg_grad(dn)``
    receives the rows' grad in backward (see ``neg_logits``)."""
    return neg_logits(out_emb, neg_emb, segment=None, tau=tau,
                      on_neg_grad=on_neg_grad)


class _SegmentedLogits(torch.autograd.Function):
    """§4.3.1 segmented fetching: per segment of tokens, gather the rows
    from ``table`` at ``fetch_dtype`` and take their logits with K9-fwd;
    backward re-gathers them, runs K9-bwd and sends dn to the sink's rows
    (or, with no sink, scatters it into a dense table grad). (T, R, D) rows
    never exist, in either direction."""

    @staticmethod
    def forward(ctx, o, table, ids, segment, inv_tau, fetch_dtype, sink):
        T, R = ids.shape
        out = torch.empty((T, R), dtype=torch.float32, device=o.device)
        for lo in range(0, T, segment):
            rows = _fetch(table, ids[lo:lo + segment], fetch_dtype)
            out[lo:lo + segment] = neg_logits_fwd(o[lo:lo + segment], rows,
                                                  inv_tau=inv_tau)
        ctx.save_for_backward(o, table, ids)
        ctx.segment, ctx.inv_tau, ctx.fetch_dtype = segment, inv_tau, \
            fetch_dtype
        ctx.sink = sink
        return out

    @staticmethod
    def backward(ctx, g):
        o, table, ids = ctx.saved_tensors
        T, R = ids.shape
        D = o.shape[1]
        seg = ctx.segment
        g = g.float().contiguous()
        do = torch.empty((T, D), dtype=torch.float32, device=o.device)
        sink_rows = dtable = None
        if ctx.sink is not None:
            sink_rows = ctx.sink.ready_rows(ids, D, o.device)
        elif ctx.needs_input_grad[1]:
            dtable = torch.zeros(table.shape, dtype=torch.float32,
                                 device=table.device)
        for lo in range(0, T, seg):
            hi = min(lo + seg, T)
            rows = _fetch(table, ids[lo:hi], ctx.fetch_dtype)
            do[lo:hi], dn = neg_logits_bwd(o[lo:hi], rows, g[lo:hi],
                                           inv_tau=ctx.inv_tau)
            if sink_rows is not None:
                sink_rows[lo * R:hi * R] = dn.reshape(-1, D)
            elif dtable is not None:
                dtable.index_add_(0, ids[lo:hi].reshape(-1).long(),
                                  dn.reshape(-1, D).float())
        if dtable is not None:
            dtable = dtable.to(table.dtype)
        return do.to(o.dtype), dtable, None, None, None, None, None


def _fetch(table: torch.Tensor, ids: torch.Tensor, fetch_dtype
           ) -> torch.Tensor:
    """One segment's rows (seg, R, D), rounded to ``fetch_dtype`` at the
    fetch: only the gathered rows are cast, never ``table``."""
    rows = table[ids.long()]
    return (rows if fetch_dtype is None else rows.to(fetch_dtype)).contiguous()


def neg_logits_segmented(out_emb: torch.Tensor, table: torch.Tensor,
                         neg_ids: torch.Tensor, *, segment: int = 128,
                         tau: float = 1.0, fetch_dtype=torch.float16,
                         table_grad_pairs: Optional[TableGradSink] = None
                         ) -> torch.Tensor:
    """§4.3.1 'offloading + segmented fetching': out (T, D), table (V, D),
    neg_ids (T, R) → (T, R) fp32 logits, the rows fetched from ``table``
    one ``segment`` of tokens at a time at ``fetch_dtype`` (§4.3.2), so
    the live rows are (segment, R, D), never (T, R, D). T must be a
    ``segment`` multiple, as the reference asserts. ``table_grad_pairs``
    receives the rows' table grad as (ids, fp32 rows); without it the
    table gets a dense grad if it requires one (test sizes)."""
    T, R = neg_ids.shape
    if T % segment:
        raise ValueError(f"{T} tokens are not a multiple of the segment "
                         f"{segment}")
    return _SegmentedLogits.apply(out_emb.contiguous(), table, neg_ids,
                                  segment, 1.0 / tau, fetch_dtype,
                                  table_grad_pairs)


def share_logits(neg_logits: torch.Tensor, expansion: int,
                 valid: Optional[torch.Tensor] = None, *,
                 draws: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """§4.3.3 intra-batch logit sharing: (T, R) → (T, R·k), each token's
    (k−1)·R extra logits drawn from the pool of all tokens' logits but its
    own, with no extra embedding lookup. Invalid tokens' pool slots are
    masked to NEG_POOL (they add exp(NEG_POOL) ≈ 0). ``draws`` (T,
    (k−1)·R) are the raw draws in [0, (T−1)·R), before the token's own
    block is skipped (the tests inject the reference's); else they come
    from ``generator`` (the reference draws with ``jax.random``: a
    declared divergence, the same distribution)."""
    T, R = neg_logits.shape
    if expansion <= 1:
        return neg_logits
    n_aux = (expansion - 1) * R
    pool = neg_logits.reshape(T * R)
    if valid is not None:
        pool = torch.where(valid.reshape(T).repeat_interleave(R), pool,
                           torch.full_like(pool, NEG_POOL))
    dev = neg_logits.device
    if draws is None:
        gen_dev = generator.device if generator is not None else dev
        draws = torch.randint(0, (T - 1) * R, (T, n_aux),
                              generator=generator, device=gen_dev)
    idx = draws.to(device=dev, dtype=torch.int64)
    if idx.shape != (T, n_aux):
        raise ValueError(f"draws {tuple(idx.shape)}, expected {(T, n_aux)}")
    own = torch.arange(T, device=dev)[:, None] * R
    idx = torch.where(idx >= own, idx + R, idx)
    return torch.cat([neg_logits, pool[idx]], dim=-1)


def _masked_mean(nll: torch.Tensor, valid: Optional[torch.Tensor],
                 total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean over valid tokens; ``total``: the count to divide by in
    place of this call's own (a sharded batch's global count)."""
    if valid is None:
        return nll.mean()
    v = valid.to(torch.float32)
    return (nll * v).sum() / (v.sum() if total is None else total).clamp(
        min=1.0)


def sampled_softmax_loss(pos_logit: torch.Tensor, neg_logits: torch.Tensor,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Loss = −log(e^{l⁺} / (e^{l⁺} + Σ_j e^{l⁻_j} + Δ)) (paper Eq. 2):
    pos_logit (T,), neg_logits (T, R′) (shared logits included), valid
    (T,) mask → the mean over valid tokens."""
    all_logits = torch.cat([pos_logit[:, None], neg_logits], dim=-1)
    lse = torch.logsumexp(all_logits.float(), dim=-1)
    return _masked_mean(lse - pos_logit.float(), valid)


def recall_loss(out_emb: torch.Tensor, pos_emb: torch.Tensor,
                neg_logits: torch.Tensor, *, tau: float = 1.0,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recall objective: the positive logit o·pos/τ beside negative
    logits from one of the paths above, into Eq. 2."""
    pos = (out_emb.float() * pos_emb.float()).sum(-1) / tau
    return sampled_softmax_loss(pos, neg_logits, valid)


def positive_logits(out_emb: torch.Tensor, pos_emb: torch.Tensor,
                    tau: float = 1.0) -> torch.Tensor:
    """(T,) fp32 o·p/τ of each token and its label row."""
    return (out_emb.float() * pos_emb.float()).sum(-1) / tau


def fused_sampled_softmax_loss(out_emb: torch.Tensor, pos_emb: torch.Tensor,
                               table: torch.Tensor, neg_ids: torch.Tensor, *,
                               tau: float = 1.0, **kw) -> torch.Tensor:
    """Eq. 2 from ids: out_emb (T, D), pos_emb (T, D) label rows, table
    (V, D) fp32 master, neg_ids (T, R); the keywords are
    :func:`fused_recall_loss`'s."""
    return fused_recall_loss(out_emb, positive_logits(out_emb, pos_emb, tau),
                             table, neg_ids, tau=tau, **kw)


def fused_recall_loss(out_emb: torch.Tensor, pos_logit: torch.Tensor,
                      table: torch.Tensor, neg_ids: torch.Tensor, *,
                      perms: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      tau: float = 1.0, valid: Optional[torch.Tensor] = None,
                      segment: int = 128, expansion: int = 1,
                      fetch_dtype=torch.float16,
                      shadow: Optional[torch.Tensor] = None,
                      shadow_index: Optional[torch.Tensor] = None,
                      vocab: Optional[int] = None,
                      valid_total: Optional[torch.Tensor] = None,
                      scatter_impl: Optional[str] = None,
                      table_grad_pairs: Optional[TableGradSink] = None,
                      share: Optional[ShareLayout] = None) -> torch.Tensor:
    """Eq. 2 from ids and the positive logits (T,) fp32. ``shadow`` is the
    half-precision table the negatives are read from (else ``fetch_dtype``
    rounds master rows). ``perms``/``generator``: the §4.3.3 sharing
    shuffle (see ``make_share_perms``). ``scatter_impl``: the form of the
    table gradient, ``"fused"`` (K5) or ``"two_pass"`` (None: the tuned
    store's). A sharded table (``core/hsp.py``) passes the exchanged rows
    as ``shadow``, each negative's position in them as ``shadow_index``,
    the global ``vocab`` and the global batch's ``valid_total``; with
    sharing across its ranks, ``share`` (this rank's segments of the
    pool)."""
    lse = fused_recall_lse(out_emb, pos_logit, table, neg_ids,
                           segment=segment, tau=tau, expansion=expansion,
                           perms=perms, generator=generator, valid=valid,
                           fetch_dtype=fetch_dtype, gather_table=shadow,
                           gather_index=shadow_index, vocab=vocab,
                           scatter_impl=scatter_impl,
                           table_grad_pairs=table_grad_pairs, share=share)
    return _masked_mean(lse - pos_logit, valid, valid_total)
