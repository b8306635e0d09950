"""Jagged (variable-length) packed layout helpers.

B variable-length rows share one capacity-bounded token buffer; row i
occupies slots ``[offsets[i], offsets[i+1])`` and slots past
``offsets[-1]`` are padding. Every helper accepts one pack (offsets
``(B+1,)``) or G packs at once (offsets ``(G, B+1)``), the serving engine's
``(G, cap)`` micro-batch layout.
"""
from __future__ import annotations

import torch

#: Canonical segment id for padding slots, shared by the token metadata of
#: the attention plan and the oracles, so ``seg >= 0`` is the validity test.
NEG_SEG = -1


def segment_ids(offsets: torch.Tensor, capacity: int) -> torch.Tensor:
    """(…, capacity) int32 row id per token slot; NEG_SEG for padding."""
    slot = torch.arange(capacity, dtype=offsets.dtype, device=offsets.device)
    slot = slot.expand(*offsets.shape[:-1], capacity).contiguous()
    seg = torch.searchsorted(offsets.contiguous(), slot, right=True) - 1
    seg = seg.to(torch.int32)
    valid = slot < offsets[..., -1:]
    return torch.where(valid, seg, torch.full_like(seg, NEG_SEG))


def positions(offsets: torch.Tensor, capacity: int) -> torch.Tensor:
    """(…, capacity) int32 position within the row per slot (0 for pad)."""
    seg = segment_ids(offsets, capacity)
    segc = seg.clamp(0, offsets.shape[-1] - 2).long()
    slot = torch.arange(capacity, dtype=torch.int32, device=offsets.device)
    pos = slot - torch.gather(offsets.to(torch.int32), -1, segc)
    return torch.where(seg >= 0, pos, torch.zeros_like(pos))
