"""Item embedding tables: fp32 master plus a persistent half-precision shadow.

The shadow (paper §4.3.2) is what serving retrieval scans: the same rows
at half the bytes, and what the fused negative kernels gather from. The
invariant ``shadow == master.to(shadow.dtype)`` is kept by whoever writes
the master (``training.optim.adagrad_sparse_update`` rewrites the touched
rows of all three tensors in place); serving only reads.

:func:`lookup_quantized` is §4.3.2's half-precision fetch of gathered rows,
and :func:`multi_table_lookup` the KJT-style lookup of several feature
tables over their packed valid ids only (§4.1.2); the kernel form of the
latter is ``repro_torch.kernels.jagged_lookup`` (K7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.jagged import JaggedBatch


@dataclass(frozen=True)
class TableSpec:
    name: str
    vocab: int
    dim: int
    init_scale: float = 0.02


def init_table(spec: TableSpec, generator: Optional[torch.Generator] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """(vocab, dim) N(0, init_scale²) rows in ``dtype``, drawn in fp32 from
    ``generator`` on ``device`` (the caller's; the reference draws from a
    jax key, so the numbers differ)."""
    return (torch.randn(spec.vocab, spec.dim, dtype=torch.float32,
                        generator=generator, device=device)
            * spec.init_scale).to(dtype)


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


def lookup_quantized(table: torch.Tensor, ids: torch.Tensor,
                     qdtype=torch.float16) -> torch.Tensor:
    """§4.3.2: rows fetched in half precision. Only the gathered rows are
    cast (casting ``table`` first would copy the whole (V, D) array), so
    the negative tensor is half the bytes."""
    return table[ids.long()].to(qdtype)


def multi_table_lookup(tables: Dict[str, torch.Tensor],
                       feats: Dict[str, JaggedBatch],
                       dtype=torch.bfloat16) -> Dict[str, JaggedBatch]:
    """KJT-style lookup: a packed gather per table over its jagged ids;
    padding slots give zero rows (§4.1.2 step 1: operate on valid
    indices only)."""
    out: Dict[str, JaggedBatch] = {}
    for name, jb in feats.items():
        emb = tables[name][jb.values.long()].to(dtype)
        emb = emb * jb.valid_mask()[:, None].to(dtype)
        out[name] = JaggedBatch(values=emb, offsets=jb.offsets)
    return out


def strip_shadow(t: ShadowedTable) -> ShadowedTable:
    """Replace the shadow with a 0-row placeholder of the same dtype, so a
    checkpoint stores the master once (the shadow is derivable)."""
    if t.shadow is None:
        return t
    return t._replace(shadow=t.shadow.new_zeros((0, t.shadow.shape[-1])))


def rebuild_shadow(t: ShadowedTable) -> ShadowedTable:
    """Recompute ``shadow = master.to(qdtype)`` (restore path, or after any
    out-of-band master edit)."""
    if t.shadow is None:
        return t
    return t._replace(shadow=t.master.to(t.shadow.dtype))


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
