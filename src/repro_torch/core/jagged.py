"""Jagged (variable-length) packed layout (the port of
``repro.core.jagged``).

B variable-length rows share one capacity-bounded token buffer; row i
occupies slots ``[offsets[i], offsets[i+1])`` and slots past
``offsets[-1]`` are padding. :class:`JaggedBatch` holds the values and the
offsets of one pack (TorchRec's KeyedJaggedTensor / flash-attn's
cu_seqlens layout); :func:`from_dense`, :func:`to_dense` and
:func:`from_row_list` convert to and from it. :func:`segment_ids` and
:func:`positions` accept one pack (offsets ``(B+1,)``) or G packs at once
(offsets ``(G, B+1)``), the serving engine's ``(G, cap)`` micro-batch
layout.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
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


class JaggedBatch(NamedTuple):
    """B rows packed into ``values`` (capacity, *feat) (the tail past
    ``offsets[-1]`` is padding, zeros) with int32 ``offsets`` (B+1,),
    monotone from 0."""
    values: torch.Tensor
    offsets: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def num_rows(self) -> int:
        return self.offsets.shape[0] - 1

    def lengths(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def total(self) -> torch.Tensor:
        """The count of valid tokens (a 0-d tensor)."""
        return self.offsets[-1]

    def valid_mask(self) -> torch.Tensor:
        """(capacity,) bool: True for packed (valid) token slots."""
        slot = torch.arange(self.capacity, device=self.offsets.device)
        return slot < self.total()

    def segment_ids(self) -> torch.Tensor:
        """(capacity,) int32 row id per slot; NEG_SEG for padding."""
        return segment_ids(self.offsets, self.capacity)

    def positions(self) -> torch.Tensor:
        """(capacity,) int32 position within the row per slot (0 for
        pad)."""
        return positions(self.offsets, self.capacity)


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    while mask.dim() < ndim:
        mask = mask[..., None]
    return mask


def from_dense(dense: torch.Tensor, lengths: torch.Tensor,
               capacity: Optional[int] = None) -> JaggedBatch:
    """Pack a padded dense batch (B, L, *feat) into a JaggedBatch: the
    valid tokens first, in order (a stable partition), the tail zeroed.
    ``capacity`` (default B·L) must hold the worst case, B·L tokens."""
    B, L = dense.shape[:2]
    capacity = capacity or B * L
    if capacity < B * L:
        raise ValueError("capacity must hold the worst-case B*L tokens")
    dev = dense.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(lengths, 0).to(torch.int32)])
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None])
    flat = dense.reshape(B * L, *dense.shape[2:])
    order = torch.argsort((~mask.reshape(B * L)).to(torch.int8),
                          stable=True)
    packed = flat[order]
    if capacity > B * L:
        packed = torch.cat([packed, packed.new_zeros(
            (capacity - B * L, *dense.shape[2:]))])
    valid = torch.arange(capacity, device=dev) < offsets[-1]
    packed = packed * _expand(valid, packed.dim()).to(packed.dtype)
    return JaggedBatch(values=packed, offsets=offsets)


def to_dense(j: JaggedBatch, max_len: int, pad_value: float = 0.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpack into (B, max_len, *feat) and a bool mask (B, max_len); rows
    longer than ``max_len`` are cut, slots past a row's end hold
    ``pad_value``."""
    B = j.num_rows
    feat = j.values.shape[1:]
    dev = j.values.device
    cols = torch.arange(max_len, device=dev)[None, :]
    src = j.offsets[:-1].long()[:, None] + cols
    mask = cols < j.lengths()[:, None]
    src = torch.where(mask, src, j.capacity - 1)
    dense = j.values[src.reshape(-1)].reshape(B, max_len, *feat)
    m = _expand(mask, dense.dim()).to(dense.dtype)
    dense = dense * m + (1.0 - m) * torch.as_tensor(pad_value,
                                                    dtype=dense.dtype)
    return dense, mask


def from_row_list(rows, capacity: int, dtype=None) -> JaggedBatch:
    """Host-side constructor from a list of 1-D/2-D numpy rows (CPU
    tensors; move them with ``.to``)."""
    arrs = [np.asarray(r) for r in rows]
    feat = arrs[0].shape[1:] if arrs[0].ndim > 1 else ()
    total = sum(a.shape[0] for a in arrs)
    if total > capacity:
        raise ValueError(f"rows total {total} exceed capacity {capacity}")
    dtype = dtype or arrs[0].dtype
    values = np.zeros((capacity, *feat), dtype=dtype)
    offsets = np.zeros(len(arrs) + 1, dtype=np.int32)
    cur = 0
    for i, a in enumerate(arrs):
        values[cur:cur + a.shape[0]] = a
        cur += a.shape[0]
        offsets[i + 1] = cur
    return JaggedBatch(values=torch.from_numpy(values),
                       offsets=torch.from_numpy(offsets))


def segment_matrix_mask(offsets: torch.Tensor, capacity: int,
                        causal: bool = True) -> torch.Tensor:
    """(capacity, capacity) bool attention mask: same row (and causal)."""
    seg = segment_ids(offsets, capacity)
    same = (seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
    if causal:
        slot = torch.arange(capacity, device=offsets.device)
        same &= slot[:, None] >= slot[None, :]
    return same
