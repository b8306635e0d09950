"""The reference's hypothesis properties of the embedding-cache chunk
manager (``tests/test_cache_properties.py``) on the port's
``CachedShadowedTable``, whose window is updated in place.

Skipped wholesale without hypothesis, as the reference's file is."""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.embedding import CachedShadowedTable


def _mk_cache(vocab=96, dim=3, chunk_rows=8, capacity=4, seed=0,
              accum=False):
    rng = np.random.default_rng(seed)
    master = rng.normal(size=(vocab, dim)).astype(np.float32)
    acc = (rng.random((vocab, dim)).astype(np.float32) if accum else None)
    return CachedShadowedTable(master, capacity_chunks=capacity,
                               chunk_rows=chunk_rows, accum=acc,
                               device="cpu"), master


@settings(max_examples=25, deadline=None)
@given(ids=st.lists(st.one_of(st.integers(-8, 40), st.integers(90, 110)),
                    min_size=1, max_size=64))
def test_cached_lookup_bit_identical_to_full_table(ids):
    """Gathering any id stream (duplicates, negatives, out-of-range)
    through translate + the window equals the clip-mode gather from the
    full table, master and shadow. The draw spans chunks 0–5 and 11, at
    most 8 distinct chunks: capacity 8 never thrashes, chunk 11 always
    swaps in."""
    c, master = _mk_cache(vocab=96, chunk_rows=8, capacity=8)
    c.warm_up(None)
    win = c.init_window()
    a = np.asarray(ids, np.int64)
    plan, _ = c.prepare_batch(0, [np.unique(np.clip(a, 0, 95))])
    c.splice(win, plan)
    rows = torch.from_numpy(c.translate(a)).long()
    want = master[np.clip(a, 0, 95)]
    np.testing.assert_array_equal(win.master[rows].numpy(), want)
    np.testing.assert_array_equal(win.shadow[rows].numpy(),
                                  want.astype(np.float16))
    c.release(0, dirty=False)


@settings(max_examples=25, deadline=None)
@given(batches=st.lists(st.lists(st.integers(0, 95), min_size=1,
                                 max_size=20), min_size=1, max_size=12))
def test_cache_accounting_invariants(batches):
    """Residency maps stay a bijection, pins balance, the hit/miss split
    partitions the weighted id stream, and the eviction counter matches
    observed evictions — under any prepare/release interleaving."""
    c, _ = _mk_cache(vocab=96, chunk_rows=8, capacity=4)
    c.warm_up(None)
    c.init_window()
    total = 0
    for i, b in enumerate(batches):
        uids, counts = np.unique(np.asarray(b, np.int64),
                                 return_counts=True)
        if np.unique(uids // 8).size > 4:
            continue                       # would (correctly) thrash
        _, step = c.prepare_batch(i, [np.repeat(uids, counts)])
        total += int(counts.sum())
        assert step["hits"] + step["misses"] == int(counts.sum())
        res = np.flatnonzero(c.chunk_slot >= 0)
        assert res.size <= 4
        np.testing.assert_array_equal(c.slot_chunk[c.chunk_slot[res]], res)
        assert (c.pins >= 0).all()
        c.release(i, dirty=False)
    assert c.stats.hits + c.stats.misses == total
    assert (c.pins == 0).all()
    assert c.stats.writebacks == 0         # nothing was ever dirty


@settings(max_examples=20, deadline=None)
@given(seq=st.lists(st.tuples(st.integers(0, 11), st.booleans()),
                    min_size=1, max_size=20))
def test_eviction_never_drops_dirty_chunks(seq):
    """Numpy mirror: random chunk touches, some landing on the window in
    place; any interleaving of evictions writes the dirty rows back, so
    the materialized table equals the mirror exactly, and so does the host
    store after a flush."""
    c, master = _mk_cache(vocab=96, chunk_rows=8, capacity=4, accum=True)
    mirror = master.copy()
    c.warm_up(None)
    win = c.init_window()
    for i, (chunk, make_dirty) in enumerate(seq):
        uids = np.arange(chunk * 8, chunk * 8 + 8)
        plan, _ = c.prepare_batch(i, [uids])
        c.splice(win, plan)
        if make_dirty:                     # a sparse landing, in place
            win.master[torch.from_numpy(c.translate(uids)).long()] += \
                float(i + 1)
            mirror[uids] += float(i + 1)
        c.release(i, dirty=make_dirty)
    np.testing.assert_array_equal(c.materialize().master, mirror)
    c.flush()
    assert not c.dirty.any()
    np.testing.assert_array_equal(c.host_master[:96], mirror)
