"""Item embedding tables: fp32 master plus a persistent half-precision shadow.

The shadow (paper §4.3.2) is what serving retrieval scans: the same rows
at half the bytes. The invariant ``shadow == master.to(shadow.dtype)`` is
kept by whoever writes the master (the training optimizer, a later slice
of the port); serving only reads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ShadowedTable(NamedTuple):
    """fp32 master + persistent half-precision shadow + AdaGrad accumulator.

    A serving-only table carries a ``(0, D)`` accumulator: only the
    training optimizer reads it, and at production vocab sizes a ``(V, D)``
    fp32 one is dead state."""
    master: torch.Tensor                # (V, D) fp32
    shadow: Optional[torch.Tensor]      # (V, D) fp16/bf16, or None
    accum: torch.Tensor                 # (V, D) fp32, or (0, D) for serving


def make_shadowed(master: torch.Tensor, qdtype=torch.float16,
                  accum: Optional[torch.Tensor] = None) -> ShadowedTable:
    """Build a ShadowedTable from an fp32 master. ``qdtype=None`` → no
    shadow."""
    shadow = None if qdtype is None else master.to(qdtype)
    if accum is None:
        accum = torch.zeros_like(master, dtype=torch.float32)
    return ShadowedTable(master=master, shadow=shadow, accum=accum)


def lookup(table: torch.Tensor, ids: torch.Tensor,
           dtype=torch.bfloat16) -> torch.Tensor:
    """Plain row gather, cast to the compute dtype: ids (...) → (..., D)."""
    return table[ids.long()].to(dtype)


def live_shadow(t: ShadowedTable) -> Optional[torch.Tensor]:
    """The shadow iff it is usable as a scan source: present and full-size
    (a checkpoint-stripped 0-row placeholder is not)."""
    if t.shadow is not None and t.shadow.shape[0] == t.master.shape[0]:
        return t.shadow
    return None


def shadow_consistent(t: ShadowedTable) -> bool:
    """True iff the shadow invariant holds exactly."""
    if t.shadow is None:
        return True
    return bool(torch.equal(t.master.to(t.shadow.dtype), t.shadow))
