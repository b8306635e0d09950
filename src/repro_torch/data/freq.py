"""Per-batch id-frequency statistics (host-side numpy): the port's copy of
``repro.data.freq``.

The admission and warm-up signal of the host-offloaded embedding cache
(:class:`repro_torch.embedding.cache.CachedShadowedTable`): a ``(vocab,)``
occurrence histogram over the id features of one or more jagged batches,
summed over a stream prefix for the LFU warm-up.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

ID_FEATURES = ("ids", "labels", "neg_ids")


def id_frequency_histogram(ids, vocab: int,
                           out: Optional[np.ndarray] = None) -> np.ndarray:
    """Occurrence counts per id, clamped to ``[0, vocab)`` — the clip every
    table read applies, so the histogram weights exactly the rows training
    touches. Accumulates into ``out`` when given."""
    if out is None:
        out = np.zeros(vocab, np.int64)
    a = np.clip(np.asarray(ids, np.int64).reshape(-1), 0, vocab - 1)
    out += np.bincount(a, minlength=vocab)
    return out


def batch_id_histogram(batch, vocab: int,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """Histogram over one jagged batch's full candidate set (input ids +
    labels + negatives): the ids the train step gathers and the sparse
    optimizer writes."""
    if out is None:
        out = np.zeros(vocab, np.int64)
    for k in ID_FEATURES:
        if k in batch:
            id_frequency_histogram(batch[k], vocab, out=out)
    return out


def stream_id_histogram(batches: Iterable, vocab: int) -> np.ndarray:
    """:func:`batch_id_histogram` summed over a stream prefix (cache
    warm-up: feed the first few batches, then ``cache.warm_up(hist)``)."""
    out = np.zeros(vocab, np.int64)
    for b in batches:
        batch_id_histogram(b, vocab, out=out)
    return out
