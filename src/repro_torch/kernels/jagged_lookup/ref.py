"""The plain PyTorch version of the sorted run-sum kernel (K6), and the
dense scatter oracle."""
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


def scatter_add_ref(grad_rows: torch.Tensor, ids: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """Σ grad_rows per id → dense (vocab, D) fp32; ids outside [0, vocab)
    dropped. Builds the (V, D) array: for test sizes only."""
    keep = (ids >= 0) & (ids < vocab)
    out = torch.zeros((vocab, grad_rows.shape[1]), dtype=torch.float32,
                      device=grad_rows.device)
    return out.index_add_(0, ids[keep].long(), grad_rows[keep].float())
