"""Sharded quantized top-k retrieval over the item embedding table.

Scoring streams the table in vocab blocks and keeps a running (B, k)
partial top-k, so peak live memory is O(B·block_v + B·k) and the table is
read once per retrieval batch:

    for each vocab block s:                         (block_v, D) rows
        scores_s = emb @ dequant(block_s).T         (B, block_v) fp32
        carry    = top_k(concat(carry, top_k(scores_s)))

Pointing the scan at the FP16 shadow halves the bytes it reads. Plain
``torch.matmul`` + ``torch.topk``, as the JAX package leaves these to XLA;
:func:`topk_dense` (full fp32 scoring) is the parity oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.embedding.tables import ShadowedTable, live_shadow


def topk_dense(emb: torch.Tensor, table: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parity oracle: full (B, V) fp32 scoring + one global top-k →
    (scores fp32, ids int32)."""
    scores = emb.float() @ table.float().T
    vals, idx = torch.topk(scores, k, dim=-1)
    return vals, idx.to(torch.int32)


def topk_blocked(emb: torch.Tensor, table: torch.Tensor, *, k: int,
                 block_v: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked-scan top-k: per-block partial top-k → running merge.

    emb (B, d) any float dtype; table (V, D) fp32 master or fp16/bf16
    shadow, cast to fp32 a block at a time. Returns fp32 (B, k) scores and
    int32 (B, k) ids, score-descending. The last block re-slides its window
    to V − block_v and masks the ids the previous block already scored, so
    no padded copy of the table is made."""
    B, _ = emb.shape
    V = table.shape[0]
    if k > V:
        raise ValueError(f"k={k} exceeds vocab {V}")
    block_v = min(block_v, V)
    kb = min(k, block_v)
    nblk = -(-V // block_v)
    ef = emb.float()
    dev = emb.device
    ar = torch.arange(block_v, dtype=torch.int32, device=dev)
    vals = torch.full((B, k), float("-inf"), dtype=torch.float32, device=dev)
    idx = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for i in range(nblk):
        start = min(i * block_v, V - block_v)
        s = ef @ table[start:start + block_v].float().T      # (B, block_v)
        gidx = start + ar
        # the re-slid last window overlaps the previous block: score each
        # id exactly once by masking ids below this block's nominal start
        if start < i * block_v:
            s = s.masked_fill((gidx < i * block_v)[None, :], float("-inf"))
        bv, bi = torch.topk(s, kb, dim=-1)
        cand_v = torch.cat([vals, bv], dim=1)
        cand_i = torch.cat([idx, gidx[bi]], dim=1)
        vals, sel = torch.topk(cand_v, k, dim=-1)
        idx = torch.gather(cand_i, 1, sel)
    return vals, idx


# --------------------------------------------------------------------------
# byte accounting
# --------------------------------------------------------------------------

def table_scan_bytes(table: torch.Tensor,
                     block_v: Optional[int] = None) -> int:
    """Device-memory bytes one retrieval pass reads from ``table``: with
    ``block_v``, ceil(V/block_v) windows of block_v rows (the re-slid last
    window re-reads some rows); without it, exactly V rows."""
    V, D = int(table.shape[0]), int(table.shape[1])
    rows = V
    if block_v is not None:
        bv = min(block_v, V)
        rows = -(-V // bv) * bv
    return rows * D * table.element_size()


def bytes_per_query(table: torch.Tensor, batch: int,
                    block_v: Optional[int] = None) -> float:
    """Table bytes per ranked request at retrieval batch size ``batch``."""
    return table_scan_bytes(table, block_v) / max(int(batch), 1)


class ShardedTopK:
    """Configured retrieval entry: picks the scan table (the shadow when
    there is one, unless ``use_shadow=False``) and runs the blocked scan."""

    def __init__(self, k: int, *, block_v: int = 4096,
                 use_shadow: bool = True):
        self.k = k
        self.block_v = block_v
        self.use_shadow = use_shadow

    def scan_table(self, table: ShadowedTable) -> torch.Tensor:
        shadow = live_shadow(table) if self.use_shadow else None
        return table.master if shadow is None else shadow

    @torch.no_grad()
    def __call__(self, table: ShadowedTable, emb: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return topk_blocked(emb, self.scan_table(table), k=self.k,
                            block_v=self.block_v)

