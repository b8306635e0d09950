"""The plain PyTorch versions of the sorted run-sum kernels (K6, K5) and of
the row gather (K7), and the dense scatter oracle."""
from __future__ import annotations

import torch


def run_totals_plain(rows: torch.Tensor, order: torch.Tensor,
                     sids: torch.Tensor, n_runs: int,
                     drop_key: int) -> torch.Tensor:
    """What ``csrc/runsum.cu`` computes: rows (n, D) fp32 taken in sorted
    order (``rows[order]``, ids ``sids`` ascending) → run r's total at row
    r, (n_runs, D) fp32, rows added in sorted order; the run of dropped ids
    (``sids >= drop_key``) totals zero."""
    srows = rows[order] * (sids < drop_key)[:, None].to(rows.dtype)
    is_start = torch.ones_like(sids, dtype=torch.bool)
    is_start[1:] = sids[1:] != sids[:-1]
    run = torch.cumsum(is_start.long(), 0) - 1
    totals = torch.zeros((n_runs, rows.shape[1]), dtype=torch.float32,
                         device=rows.device)
    return totals.index_add_(0, run, srows)


def weighted_run_totals_plain(o: torch.Tensor, w: torch.Tensor,
                              extra: torch.Tensor, order: torch.Tensor,
                              sids: torch.Tensor, n_runs: int, drop_key: int,
                              scale: float) -> torch.Tensor:
    """What ``csrc/wscatter.cu`` computes: the n_neg = n − len(extra)
    negative slots' rows ``w.flat[j] · (float(o[j // R]) · scale)`` (w
    (T, R)), then the ready rows ``extra``, summed per run as
    :func:`run_totals_plain` does. The rows are built here, in the two-pass
    path's op order, so the totals equal two-pass rows + K6 bit for bit."""
    n_neg = order.numel() - extra.shape[0]
    R, D = w.shape[1], o.shape[1]
    T = n_neg // R
    neg = (w[:T, :, None] * (o[:T].float() * scale)[:, None]).reshape(
        n_neg, D)
    return run_totals_plain(torch.cat([neg, extra.float()]), order, sids,
                            n_runs, drop_key)


def scatter_add_ref(grad_rows: torch.Tensor, ids: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """Σ grad_rows per id → dense (vocab, D) fp32; ids outside [0, vocab)
    dropped. Builds the (V, D) array: for test sizes only."""
    keep = (ids >= 0) & (ids < vocab)
    out = torch.zeros((vocab, grad_rows.shape[1]), dtype=torch.float32,
                      device=grad_rows.device)
    return out.index_add_(0, ids[keep].long(), grad_rows[keep].float())


def jagged_lookup_ref(table: torch.Tensor, ids: torch.Tensor, *,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version of K7 (``csrc/gather.cu``) and of
    ``ops.jagged_lookup``'s forward: ids (n,) → (n, D) ``compute_dtype``,
    row ``table[min(id, V − 1)]`` cast once, zeros for ids < 0."""
    ids = ids.reshape(-1)
    rows = table[ids.long().clamp(0, table.shape[0] - 1)].to(compute_dtype)
    return torch.where((ids >= 0)[:, None], rows,
                       torch.zeros((), dtype=compute_dtype,
                                   device=rows.device))
