"""Asynchronous negative offload (paper §4.3.1): the (T, R, D) negative
rows live in pinned host memory and reach the card one segment of tokens
at a time, double-buffered, while K9 runs on the segment before.

:func:`offload_negatives` moves a card tensor of rows to pinned host
memory (the reference's ``offload_negatives``; a CPU tensor stays as it
is, the reference's branch for a platform without pinned host memory).
:func:`neg_logits_offloaded` is the segmented consumer the reference's
docstring names: out (T, D) on the card × rows (T, R, D) on the host →
(T, R) fp32 logits o·n/τ, differentiable in both.

- Forward: a side stream copies segment s+1's rows host → card into one of
  two (segment, R, D) buffers while the main stream runs K9-fwd
  (``neg_logits_fwd``) on segment s in the other. Events order each
  buffer's reuse: a copy waits for the K9 launch that last read its
  buffer, a launch for the copy that filled its buffer. The buffers are
  freed only after the main stream has waited for every copy, so the
  caching allocator (which knows the main stream only) never hands them
  out early.
- Backward: the rows stream in again the same way; K9-bwd runs per segment
  into one of two card buffers of dn, and a second side stream sends each
  back card → host into a pinned (T, R, D) grad in the rows' dtype, while
  the next segment's rows come in (the link carries both directions at
  once). ``do`` stays on the card. The backward waits for the last copy
  out before it returns, so the host grad is whole when autograd or the
  caller reads it.

On the card the (T, R, D) rows never exist, in either direction: the most
it holds of them is two segments of rows and two of dn. On the CPU (the
tests) the same segments run through K9's plain versions, with no streams.
A host tensor that is not pinned is refused with a card ``out_emb``: its
copies would run synchronously and hide nothing.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

from repro_torch.kernels.neg_logits import neg_logits_bwd, neg_logits_fwd

__all__ = ["neg_logits_offloaded", "offload_negatives"]


def offload_negatives(neg_emb: torch.Tensor) -> torch.Tensor:
    """A card tensor → a pinned host tensor of the same values and dtype
    (one copy, complete when this returns); a CPU tensor → itself. A
    failure to pin raises (nothing falls back to the card)."""
    if neg_emb.device.type == "cpu":
        return neg_emb
    if neg_emb.device.type != "cuda":
        raise ValueError(f"offload_negatives: unsupported device "
                         f"{neg_emb.device}")
    host = torch.empty(neg_emb.shape, dtype=neg_emb.dtype, pin_memory=True)
    host.copy_(neg_emb)
    return host


class _RowStream:
    """Segments of the pinned host rows on their way to the card: two card
    buffers of (segment, R, D), filled on a side stream one segment ahead
    of the main stream's use."""

    def __init__(self, host: torch.Tensor, segment: int,
                 device: torch.device):
        self.host, self.segment = host, segment
        self.main = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        self.bufs = [torch.empty((segment, *host.shape[1:]), dtype=host.dtype,
                                 device=device) for _ in range(2)]
        self.landed = [torch.cuda.Event() for _ in range(2)]
        self.read = [torch.cuda.Event() for _ in range(2)]

    def _fetch(self, s: int) -> None:
        b, lo = s % 2, s * self.segment
        with torch.cuda.stream(self.copy):
            if s >= 2:           # the launch on segment s-2 read this buffer
                self.copy.wait_event(self.read[b])
            self.bufs[b].copy_(self.host[lo:lo + self.segment],
                               non_blocking=True)
            self.landed[b].record(self.copy)

    def __iter__(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """(first token, the segment's rows on the card): the main stream
        has waited for them; the caller enqueues its reads of them on the
        main stream before it asks for the next segment."""
        n_seg = self.host.shape[0] // self.segment
        self.copy.wait_stream(self.main)     # the buffers' allocation
        self._fetch(0)
        for s in range(n_seg):
            if s + 1 < n_seg:
                self._fetch(s + 1)
            b = s % 2
            self.main.wait_event(self.landed[b])
            yield s * self.segment, self.bufs[b]
            self.read[b].record(self.main)


class _OffloadedLogits(torch.autograd.Function):
    """o (T, D) on the card (or the CPU) × n (T, R, D) pinned on the host
    (or on the CPU) → (T, R) fp32: K9 per segment over rows streamed in."""

    @staticmethod
    def forward(ctx, o, n_host, segment, inv_tau):
        T, R, _ = n_host.shape
        out = torch.empty((T, R), dtype=torch.float32, device=o.device)
        for lo, rows in _segments(n_host, segment, o.device):
            out[lo:lo + segment] = neg_logits_fwd(o[lo:lo + segment], rows,
                                                  inv_tau=inv_tau)
        ctx.save_for_backward(o, n_host)
        ctx.segment, ctx.inv_tau = segment, inv_tau
        return out

    @staticmethod
    def backward(ctx, g):
        o, n_host = ctx.saved_tensors
        seg, inv_tau = ctx.segment, ctx.inv_tau
        T, D = o.shape
        g = g.float().contiguous()
        do = torch.empty((T, D), dtype=torch.float32, device=o.device)
        if o.device.type == "cpu":
            dn_host = torch.empty_like(n_host)
            for lo, rows in _segments(n_host, seg, o.device):
                do[lo:lo + seg], dn_host[lo:lo + seg] = neg_logits_bwd(
                    o[lo:lo + seg], rows, g[lo:lo + seg], inv_tau=inv_tau)
            return do.to(o.dtype), dn_host, None, None
        dn_host = torch.empty(n_host.shape, dtype=n_host.dtype,
                              pin_memory=True)
        main = torch.cuda.current_stream(o.device)
        back = torch.cuda.Stream(o.device)
        back.wait_stream(main)               # dn_bufs' allocation
        dn_bufs = [torch.empty((seg, *n_host.shape[1:]), dtype=n_host.dtype,
                               device=o.device) for _ in range(2)]
        written = [torch.cuda.Event() for _ in range(2)]
        sent = [torch.cuda.Event() for _ in range(2)]
        for s, (lo, rows) in enumerate(_segments(n_host, seg, o.device)):
            b = s % 2
            if s >= 2:        # segment s-2's dn has left this buffer
                main.wait_event(sent[b])
            do[lo:lo + seg], _ = neg_logits_bwd(
                o[lo:lo + seg], rows, g[lo:lo + seg], inv_tau=inv_tau,
                dn=dn_bufs[b])
            written[b].record(main)
            with torch.cuda.stream(back):
                back.wait_event(written[b])
                dn_host[lo:lo + seg].copy_(dn_bufs[b], non_blocking=True)
                sent[b].record(back)
        back.synchronize()                   # the host grad is whole
        return do.to(o.dtype), dn_host, None, None


def _segments(n_host: torch.Tensor, segment: int, device: torch.device):
    """(first token, rows) per segment: streamed to the card through
    :class:`_RowStream`, or the host rows themselves for a CPU ``o``."""
    if device.type == "cuda":
        return iter(_RowStream(n_host, segment, device))
    return ((lo, n_host[lo:lo + segment])
            for lo in range(0, n_host.shape[0], segment))


def neg_logits_offloaded(out_emb: torch.Tensor, neg_host: torch.Tensor, *,
                         segment: int = 128, tau: float = 1.0
                         ) -> torch.Tensor:
    """§4.3.1's offloaded negatives, consumed a segment at a time:
    out_emb (T, D) on the card × neg_host (T, R, D) in pinned host memory
    (:func:`offload_negatives`) → (T, R) fp32 logits o·n/τ on the card,
    bit for bit K9 on the same segments held on the card. Differentiable
    in both: ``do`` on the card in out_emb's dtype, dn a pinned host
    (T, R, D) tensor in neg_host's dtype. With a CPU out_emb, a CPU
    neg_host and K9's plain versions. T must be a ``segment`` multiple, as
    the reference's segmented path asserts."""
    if out_emb.dim() != 2 or neg_host.dim() != 3 \
            or neg_host.shape[0] != out_emb.shape[0] \
            or neg_host.shape[2] != out_emb.shape[1]:
        raise ValueError(f"out_emb {tuple(out_emb.shape)}, neg_host "
                         f"{tuple(neg_host.shape)}: takes (T, D), (T, R, D)")
    T = out_emb.shape[0]
    if T % segment:
        raise ValueError(f"{T} tokens are not a multiple of the segment "
                         f"{segment}")
    if neg_host.device.type != "cpu":
        raise ValueError(f"neg_host lies on {neg_host.device}: the offloaded "
                         f"path takes host rows (offload_negatives)")
    if out_emb.device.type == "cuda":
        if not (neg_host.is_pinned() and neg_host.is_contiguous()):
            raise ValueError("neg_host is not contiguous pinned host memory:"
                             " its copies to the card would run "
                             "synchronously; pin it (offload_negatives)")
    elif out_emb.device.type != "cpu":
        raise ValueError(f"neg_logits_offloaded: unsupported device "
                         f"{out_emb.device}")
    return _OffloadedLogits.apply(out_emb.contiguous(),
                                  neg_host.contiguous(), segment, 1.0 / tau)
