"""The port's host-offloaded embedding cache (``embedding/cache.py``,
``data/freq.py``) and the engine's cache path.

Against the reference: the id histograms exactly; the chunk manager driven
by one sequence of calls (warm-up, prepare, release, deferred releases,
adopt, flush) into the same chunk maps, LFU counters, stats, dirty-row
records, thrash points and materialized table; the all-resident cached
engine within the training slice's tolerances. Inside the port: the
bincount weights and touched-row masks equal what ``host_unique_candidates``
gives, and the cached engine equals the uncached engine bit for bit
(losses, the vocab-sized state of ``full_snapshot``: dense params,
moments, master, accumulator, carry), all-resident and capacity limited,
sync and τ=1, flat and Algorithm 1, through a checkpoint round trip and a
recovery of ``run_resilient``. The reference's own capacity-limited cached
runs are not bitwise (XLA's dense table-grad scatter sums in another order
once ids are slot ids), so they are not compared."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import freq as JF
from repro.embedding import cache as JC
from repro.models.model_zoo import get_bundle as j_bundle
from repro.training import checkpoint as JCKPT
from repro.training import trainer as JT
from repro.training.engine import GREngine as JEngine
from repro_torch.convert import (gr_params_from_numpy, pending_to_numpy,
                                 shadowed_table_from_numpy)
from repro_torch.data import GRLoader as PLoader
from repro_torch.data import SyntheticKuaiRand as PSynth
from repro_torch.data import freq as PF
from repro_torch.embedding import CachedShadowedTable, CacheThrash
from repro_torch.embedding import cache as PC
from repro_torch.embedding.tables import shadow_consistent
from repro_torch.models.model_zoo import GRBundle
from repro_torch.obs import Obs
from repro_torch.training import GREngine, gr_train_state
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import host_unique_candidates
from repro_torch.training import resilience as R
from test_torch_engine import LK, SEG, _loader
from test_torch_engine import R as N_NEG
from test_torch_resilience import _assert_same_state, _ref_pair
from test_torch_training import TOLS, _assert_close
from torch_parity import CPU, configs, tree_numpy

VOCAB, CHUNK = 512, 32           # 16 chunks
BANDS, BAND_CHUNKS, CAP = 8, 2, 64


# --------------------------------------------------------------------------
# data/freq.py
# --------------------------------------------------------------------------

def test_freq_histograms_match_reference():
    rng = np.random.default_rng(0)
    batches = [{"ids": rng.integers(-5, 60, (2, 16)),
                "labels": rng.integers(0, 70, (2, 16)),
                "neg_ids": rng.integers(-3, 80, (2, 16, 4)),
                "offsets": np.array([[0, 16], [0, 9]])} for _ in range(3)]
    V = 64
    for b in batches:
        np.testing.assert_array_equal(PF.batch_id_histogram(b, V),
                                      JF.batch_id_histogram(b, V))
        np.testing.assert_array_equal(
            PF.id_frequency_histogram(b["neg_ids"], V),
            JF.id_frequency_histogram(b["neg_ids"], V))
    np.testing.assert_array_equal(PF.stream_id_histogram(batches, V),
                                  JF.stream_id_histogram(batches, V))
    assert PF.ID_FEATURES == JF.ID_FEATURES


# --------------------------------------------------------------------------
# the chunk manager against the reference's
# --------------------------------------------------------------------------

def _caches(vocab=96, dim=3, chunk_rows=8, capacity=4, seed=0):
    rng = np.random.default_rng(seed)
    master = rng.normal(size=(vocab, dim)).astype(np.float32)
    accum = rng.random((vocab, dim)).astype(np.float32)
    kw = dict(capacity_chunks=capacity, chunk_rows=chunk_rows, accum=accum)
    return (JC.CachedShadowedTable(master, **kw),
            CachedShadowedTable(master, device="cpu", **kw), master)


def _prepare(c, batch, uids, counts=None):
    """The reference's ``prepare(batch, uids, counts)`` on the port's
    cache: the unique ids repeated by their counts, as the batch's table
    reads."""
    ids = np.asarray(uids) if counts is None else np.repeat(uids, counts)
    return c.prepare_batch(batch, [ids])


def _assert_same_manager(j, p, what):
    for k in ("chunk_slot", "slot_chunk", "freq", "dirty", "pins"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k),
                                      err_msg=f"{what}: {k}")
    assert p.counters() == j.counters(), what
    assert sorted(p.dirty_rows) == sorted(j.dirty_rows), what
    for c, m in j.dirty_rows.items():
        np.testing.assert_array_equal(p.dirty_rows[c], m, err_msg=what)
    np.testing.assert_array_equal(p.host_master, j.host_master,
                                  err_msg=what)
    np.testing.assert_array_equal(p.host_accum, j.host_accum, err_msg=what)
    np.testing.assert_array_equal(p.resident_chunks(), j.resident_chunks(),
                                  err_msg=what)


@pytest.mark.parametrize("capacity,seed", [(4, 0), (5, 1), (3, 2)])
def test_chunk_manager_follows_the_reference(capacity, seed):
    """One random sequence of warm_up, prepare (some of which thrash),
    in-place landings of a batch's rows, release (dirty or clean),
    defer_release / release_pending, adopt and flush on both caches: after
    every call the same chunk maps, LFU counters, pins, dirty flags and
    row records, stats and host store; the same window rows under
    translation; at the end the same materialized table."""
    j, p, _ = _caches(capacity=capacity, seed=seed)
    rng = np.random.default_rng(100 + seed)
    hist = rng.integers(0, 5, 96)
    np.testing.assert_array_equal(p.warm_up(hist), j.warm_up(hist))
    jwin = j.init_window()
    p.init_window()
    live, pending, thrashed = [], None, 0
    for step in range(40):
        op = rng.integers(0, 6)
        if op <= 1 or not live:
            b = 1000 + step
            chunks = rng.choice(12, size=rng.integers(1, 4), replace=False)
            uids = np.unique(np.concatenate([
                c * 8 + rng.choice(8, size=rng.integers(1, 5), replace=False)
                for c in chunks]))
            counts = rng.integers(1, 4, uids.size)
            try:
                jplan, jst = j.prepare(b, uids, counts)
            except JC.CacheThrash:
                with pytest.raises(CacheThrash):
                    _prepare(p, b, uids, counts)
                thrashed += 1
                _assert_same_manager(j, p, f"thrash {step}")
                continue
            pplan, pst = _prepare(p, b, uids, counts)
            assert pst == jst, step
            jwin = j.splice(jwin, jplan)
            j.publish(jwin)
            p.splice(p.window, pplan)
            rows = j.translate(uids)
            np.testing.assert_array_equal(p.translate(uids), rows)
            np.testing.assert_array_equal(p.window.master.numpy()[rows],
                                          np.asarray(jwin.master)[rows])
            np.testing.assert_array_equal(p.window.shadow.numpy()[rows],
                                          np.asarray(jwin.shadow)[rows])
            live.append((b, uids))
        elif op == 2 and pending is None:
            b, uids = live.pop(rng.integers(len(live)))
            j.defer_release(b)
            p.defer_release(b)
            pending = (b, uids)
        elif op == 3 and pending is not None:
            j.release_pending()
            p.release_pending()
            pending = None
        else:
            b, uids = live.pop(rng.integers(len(live)))
            dirty = bool(rng.integers(0, 2))
            if dirty:       # the batch's landing, in both windows
                rows = j.translate(uids)
                v = float(step + 1)
                jwin = jwin._replace(master=jwin.master.at[rows].add(v),
                                     accum=jwin.accum.at[rows].add(v))
                j.publish(jwin)
                p.window.master[torch.from_numpy(rows).long()] += v
                p.window.accum[torch.from_numpy(rows).long()] += v
            j.release(b, dirty=dirty)
            p.release(b, dirty=dirty)
        _assert_same_manager(j, p, f"step {step} op {op}")
        if step == 25:
            # a restore mid-stream: adopt the materialized table with the
            # pending batch's ids as the carry
            for b, _ in live:
                j.release(b, dirty=False)
                p.release(b, dirty=False)
            live = []
            pids = (np.full(3, -1) if pending is None
                    else np.concatenate([pending[1], [-1]]))
            full = j.materialize(jwin)
            jwin, jslots = j.adopt(full, pids)
            _, pslots = p.adopt(p.materialize(), pids)
            np.testing.assert_array_equal(pslots, jslots)
            _assert_same_manager(j, p, "adopt")
    jm, pm = j.materialize(jwin), p.materialize()
    np.testing.assert_array_equal(pm.master, np.asarray(jm.master))
    np.testing.assert_array_equal(pm.accum, np.asarray(jm.accum))
    assert pm.shadow.shape == (0, 3) and pm.shadow.dtype == torch.float16
    j.flush(jwin)
    p.flush()
    _assert_same_manager(j, p, "flush")
    assert thrashed > 0          # the sequence reaches the thrash point


def test_thrash_names_the_working_set():
    _, p, _ = _caches(capacity=2)
    p.warm_up(None)
    p.init_window()
    _prepare(p, 0, np.array([0, 8]))
    with pytest.raises(CacheThrash, match=r"pins 3 chunks \(batches \[0, 1\]\)"):
        _prepare(p, 1, np.array([16]))
    assert (p.pins[[0, 1]] == 1).all() and p.pins.sum() == 2


def test_splice_lands_chunks_a_later_prepare_admitted():
    """Prepares run concurrently, so batch 1's may admit a chunk before
    batch 0's runs and hits it: batch 0's splice must land that chunk
    (batch 1's, later, lands nothing twice)."""
    _, p, master = _caches(capacity=4)
    p.warm_up(None)                      # chunks 0-3 resident
    win = p.init_window()
    plan1, st1 = _prepare(p, 1, np.array([40, 41, 2]))
    plan0, st0 = _prepare(p, 0, np.array([41, 42, 3]))
    assert st1["loaded_chunks"] == 1 and st0["loaded_chunks"] == 0
    assert plan0 is not None and plan0.loads == plan1.loads
    p.splice(win, plan0)
    rows = torch.from_numpy(p.translate([41, 42, 3])).long()
    np.testing.assert_array_equal(win.master[rows].numpy(),
                                  master[[41, 42, 3]])
    np.testing.assert_array_equal(win.shadow[rows].numpy(),
                                  master[[41, 42, 3]].astype(np.float16))
    win.master[rows] += 1.0              # batch 0's landing
    p.release(0)
    p.splice(win, plan1)                 # already landed: not again
    np.testing.assert_array_equal(win.master[rows].numpy(),
                                  master[[41, 42, 3]] + 1.0)
    p.release(1, dirty=False)
    assert p._loading == {}


def test_concurrent_prepares_and_releases_keep_the_books():
    """Eight threads (more than the engine's workers) prepare batches of
    one chunk each (9 slots of 12 chunks: evictions, dirty writebacks),
    land in place and release them at once, under a tiny switch interval:
    every batch's window rows equal the host mirror after its splice, the
    residency maps stay a bijection, pins balance, and the hit/miss split
    partitions every weighted id."""
    import sys
    import threading
    c, master = _caches(capacity=9)[1:]   # 8 pinned at most: no thrash
    c.warm_up(None)
    win = c.init_window()
    mirror = master.copy()
    main = threading.Lock()       # splices and landings: one at a time
    total, errors = [0], []

    def worker(t):
        rng = np.random.default_rng(t)
        try:
            for k in range(25):
                b = t * 100 + k
                chunk = rng.integers(0, 12)
                uids = np.unique(rng.integers(0, 8, rng.integers(1, 9))
                                 + 8 * chunk)
                counts = rng.integers(1, 3, uids.size)
                plan, st = _prepare(c, b, uids, counts)
                with main:
                    total[0] += int(counts.sum())
                    assert st["hits"] + st["misses"] == int(counts.sum())
                    c.splice(win, plan)
                    rows = torch.from_numpy(c.translate(uids)).long()
                    np.testing.assert_array_equal(win.master[rows].numpy(),
                                                  mirror[uids])
                    win.master[rows] += 1.0
                    mirror[uids] += 1.0
                    c.release(b)
        except BaseException as e:      # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    assert (c.pins == 0).all() and c._loading == {}
    res = np.flatnonzero(c.chunk_slot >= 0)
    np.testing.assert_array_equal(c.slot_chunk[c.chunk_slot[res]], res)
    assert c.stats.hits + c.stats.misses == total[0]
    np.testing.assert_array_equal(c.materialize().master, mirror)


def test_writeback_runs_outside_the_lock():
    """A dirty victim's rows are copied back outside the cache's lock: while
    one prepare's writeback is held, the main thread's release and splice
    go on; a second prepare that admits the victim again waits for the
    writeback before it reads the victim's host rows, and so does
    materialize; once the writeback ends, both see the landed rows."""
    import threading
    _, c, master = _caches(capacity=2)
    c.warm_up(None)                      # chunks 0, 1 resident
    win = c.init_window()
    mirror = master.copy()
    plan, _ = _prepare(c, 0, np.arange(0, 4))
    c.splice(win, plan)
    win.master[torch.arange(0, 4)] += 1.0         # batch 0's landing
    mirror[0:4] += 1.0
    c.release(0)                         # chunk 0 dirty, unpinned
    plan1, _ = _prepare(c, 1, np.arange(8, 12))   # chunk 1 pinned
    gate, entered = threading.Event(), threading.Event()
    read_rows = c._read_rows

    def held(idx, events):
        entered.set()
        assert gate.wait(timeout=60)
        return read_rows(idx, events)

    c._read_rows = held
    out = {}

    def run(name, fn):
        t = threading.Thread(target=lambda: out.__setitem__(name, fn()))
        t.start()
        return t

    t2 = run("b2", lambda: _prepare(c, 2, np.arange(16, 20)))  # evicts 0
    assert entered.wait(timeout=60)
    assert c.stats.writebacks == 1 and 0 in c._draining
    assert c._lock.acquire(timeout=10)  # the lock is free
    c._lock.release()
    c.splice(win, plan1)
    c.release(1, dirty=False)            # chunk 1 evictable now
    t3 = run("b3", lambda: _prepare(c, 3, np.arange(0, 4)))    # chunk 0
    tm = run("m", c.materialize)
    t3.join(timeout=0.3)
    tm.join(timeout=0.3)
    assert t3.is_alive() and tm.is_alive()        # both wait the writeback
    gate.set()
    for t in (t2, t3, tm):
        t.join(timeout=60)
        assert not t.is_alive()
    np.testing.assert_array_equal(out["m"].master, mirror)
    c.splice(win, out["b2"][0])
    c.splice(win, out["b3"][0])
    rows = torch.from_numpy(c.translate(np.arange(0, 4))).long()
    np.testing.assert_array_equal(win.master[rows].numpy(), mirror[0:4])
    assert c._draining == {} and c.stats.evictions == 2


def test_streamed_save_copies_a_chunk_aside_before_its_writeback(
        monkeypatch):
    """``table_snapshot``'s leaves read the table as it was when it was
    taken, one chunk a piece: a chunk clean then, dirtied and evicted
    (written back) while the save is in flight and before the save reached
    it, is read from its old rows, copied aside by the writeback; a chunk
    dirty then is read from the window's rows copied at the snapshot and
    needs no copy; ``adopt`` waits until both leaves are closed."""
    import threading
    monkeypatch.setattr(PC, "SAVE_PIECE_BYTES", 8 * 3 * 4)  # one chunk
    _, c, master = _caches(capacity=2)   # 12 chunks of 8 rows, dim 3
    c.warm_up(None)                      # chunks 0, 1 resident
    win = c.init_window()

    def land(batch, ids, delta):
        plan, _ = _prepare(c, batch, ids)
        c.splice(win, plan)
        rows = torch.from_numpy(c.translate(ids)).long()
        win.master[rows] += delta
        win.accum[rows] += 2 * delta
        c.release(batch)

    land(0, np.arange(0, 4), 1.0)        # chunk 0 dirty
    want = c.materialize()
    m_leaf, a_leaf = c.table_snapshot()
    land(1, np.arange(8, 12), 5.0)       # chunk 1 dirty after the snapshot
    pieces = m_leaf.pieces()
    first = next(pieces).copy()          # the master leaf has read chunk 0
    _prepare(c, 2, np.arange(16, 32))    # chunks 2, 3 evict 0 and 1
    c.release(2, dirty=False)
    assert c.stats.writebacks == 2
    assert not np.array_equal(c.host_master[8:16], want.master[8:16])
    got_m = np.concatenate([first] + [p.copy() for p in pieces])
    got_a = np.concatenate([p.copy() for p in a_leaf.pieces()])
    np.testing.assert_array_equal(got_m, want.master)
    np.testing.assert_array_equal(got_a, want.accum)
    m_leaf.close()
    out = []
    t = threading.Thread(target=lambda: out.append(c.adopt(want)))
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive()                  # the accumulator leaf is open
    a_leaf.close()
    t.join(timeout=60)
    assert not t.is_alive() and out
    assert c.stats.cow_chunks == 1       # chunk 1 only
    with pytest.raises(RuntimeError, match="read once"):
        next(m_leaf.pieces())


def test_bincount_weights_and_masks_match_host_unique_candidates():
    """The engine's path (:meth:`prepare_batch`: one bincount, a boolean
    mask) gives the chunks, weights and touched rows the reference takes
    from the sorted candidates of ``host_unique_candidates``, and drives
    the cache into the same state as those unique ids repeated by their
    counts."""
    rng = np.random.default_rng(5)
    V, Rr = 300, 16
    b = {"ids": rng.integers(-4, 320, (2, 40)),
         "labels": rng.integers(0, 300, (2, 40)),
         "neg_ids": rng.integers(0, 330, (2, 40, 6))}
    s, first, counts = host_unique_candidates(b, V)
    uids, cnt = s[first].astype(np.int64), counts[first]
    master = np.zeros((V, 2), np.float32)
    p1 = CachedShadowedTable(master, capacity_chunks=19, chunk_rows=Rr,
                             device="cpu")
    p2 = CachedShadowedTable(master, capacity_chunks=19, chunk_rows=Rr,
                             device="cpu")
    chunks, weight, mask = p1.chunk_candidates([b[k] for k in
                                                ("ids", "labels",
                                                 "neg_ids")])
    want_chunks, inv = np.unique(uids // Rr, return_inverse=True)
    want_w = np.zeros(want_chunks.size, np.int64)
    np.add.at(want_w, inv, cnt)
    np.testing.assert_array_equal(chunks, want_chunks)
    np.testing.assert_array_equal(weight, want_w)
    got_rows = chunks[:, None] * Rr + np.arange(Rr)[None, :]
    np.testing.assert_array_equal(np.sort(got_rows[mask]), uids)
    for c in (p1, p2):
        c.warm_up(None)
        c.init_window()
    p1.prepare_batch(0, [b[k] for k in ("ids", "labels", "neg_ids")])
    _prepare(p2, 0, uids, cnt)
    for c in (p1, p2):
        c.release(0)
    _assert_same_manager(p1, p2, "raw features vs unique ids")


# --------------------------------------------------------------------------
# the engine: cached == uncached, bit for bit
# --------------------------------------------------------------------------

def _banded(i):
    """Batch i draws every id feature from one rotating band of 2 chunks,
    so a capacity-limited window evicts (and writes back) across bands
    without thrashing (the reference test's scheme)."""
    rng = np.random.default_rng(1000 + i)
    lo = (i % BANDS) * BAND_CHUNKS * CHUNK
    hi = lo + BAND_CHUNKS * CHUNK
    return {"ids": rng.integers(lo, hi, (2, CAP)).astype(np.int32),
            "labels": rng.integers(lo, hi, (2, CAP)).astype(np.int32),
            "timestamps": np.cumsum(np.ones((2, CAP), np.int32), 1,
                                    dtype=np.int32),
            "offsets": np.tile(np.asarray([0, CAP // 2, CAP], np.int32),
                               (2, 1)),
            "neg_ids": rng.integers(lo, hi, (2, CAP, N_NEG)).astype(
                np.int32),
            "rng": np.zeros((2,), np.uint32)}


@pytest.fixture(scope="module")
def tiny():
    _, cp = configs("bfloat16", n_items=VOCAB, max_seq_len=CAP)
    return GRBundle(cp.replace(num_negatives=N_NEG))


def _init_table(bundle):
    """The master GREngine(seed=0) draws (after its dense params)."""
    g = torch.Generator().manual_seed(0)
    bundle.init_dense(g, device=CPU)
    return bundle.init_table(g, device=CPU)


def _cache(bundle, capacity, hist=None):
    c = CachedShadowedTable(_init_table(bundle), capacity_chunks=capacity,
                            chunk_rows=CHUNK, device="cpu")
    c.warm_up(hist)
    return c


def _assert_same_full(a: CKPT.HostSnapshot, b: CKPT.HostSnapshot, what=""):
    assert a.paths == b.paths and a.dtypes == b.dtypes, what
    assert [tuple(x) for x in a.shapes] == [tuple(x) for x in b.shapes], what
    for path, shape, x, y in zip(a.paths, a.shapes, a.arrays, b.arrays):
        assert x.dtype == y.dtype, (what, path)
        # a snapshot keeps a 0-d leaf as (1,), a restore in its own shape
        np.testing.assert_array_equal(x.reshape(shape), y.reshape(shape),
                                      err_msg=f"{what} {path}")


def _uncached(bundle, steps, semi_async=True, schedule="algorithm1",
              data=_banded):
    eng = GREngine(bundle, data, seed=0, device="cpu", loss_kwargs=LK,
                   semi_async=semi_async, schedule=schedule)
    return eng, [r["loss"] for r in eng.run(steps)]


@pytest.mark.parametrize("capacity", [16, 10])
@pytest.mark.parametrize("schedule", ["flat", "algorithm1"])
@pytest.mark.parametrize("semi_async", [False, True])
def test_cached_engine_equals_uncached_bitwise(tiny, semi_async, schedule,
                                               capacity):
    """10 steps of banded batches: the cached engine (window of 16 of 16
    chunks, or 10: misses, evictions and dirty writebacks every band
    rotation) against the uncached engine from the same seed: every loss,
    and the full state (dense params, moments, master, accumulator, the
    τ=1 carry globalized) bit for bit; the window's shadow is its master
    rounded, and the engine trains the window, not a vocab-sized table."""
    N = 10
    ref, losses = _uncached(tiny, N, semi_async, schedule)
    cache = _cache(tiny, capacity)
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK,
                   semi_async=semi_async, schedule=schedule, cache=cache)
    recs = eng.run(N)
    assert [r["loss"] for r in recs] == losses
    _assert_same_full(eng.full_snapshot(), ref.full_snapshot())
    assert eng.state.table.master is cache.window.master
    assert eng.state.table.master.shape[0] == capacity * CHUNK
    assert shadow_consistent(cache.window)
    assert all(set(r["cache"]) >= {"hits", "misses", "evicted_chunks"}
               for r in recs)
    k = cache.counters()
    if capacity == 16:
        assert k["misses"] == k["evictions"] == 0 and k["hit_rate"] == 1.0
    else:
        assert k["misses"] > 0 and k["evictions"] > 0
        assert k["writebacks"] > 0
        assert 0 < k["writeback_rows_dirty"] <= k["writeback_rows_total"]
    if semi_async:
        assert ref.state.pending_ids.numel() > 0
    # a second run continues both the same way (the carry lands in the
    # prologue, released through release_pending)
    more = [r["loss"] for r in eng.run(3)]
    assert more == [r["loss"] for r in ref.run(3)]
    _assert_same_full(eng.full_snapshot(), ref.full_snapshot())
    assert (cache.pins == 0).all() or semi_async


def _shared_then_banded(i):
    """Batches 0-3 all read chunks 12 and 13 (not resident after
    warm_up(None) with 10 slots); later ones rotate bands."""
    if i >= 4:
        return _banded(i)
    b = _banded(0)
    rng = np.random.default_rng(7 + i)
    for k in ("ids", "labels", "neg_ids"):
        b[k] = rng.integers(12 * CHUNK, 14 * CHUNK, b[k].shape).astype(
            np.int32)
    return b


def test_cached_engine_out_of_order_prefetches(tiny):
    """The prologue's four prefetches finish in reverse order (batch 3's
    first), so batch 3's admits chunks 12 and 13 and batches 0-2 hit them
    before batch 3's splice: still bit for bit the uncached engine."""
    import time
    N = 8
    ref, losses = _uncached(tiny, N, data=_shared_then_banded)
    cache = _cache(tiny, 10)
    eng = GREngine(tiny, _shared_then_banded, seed=0, loss_kwargs=LK,
                   cache=cache, workers=4)
    unique = eng._hk_unique
    order = []

    def reversed_unique(i, art):
        if i < 4:
            time.sleep(0.15 * (3 - i))
        out = unique(i, art)
        order.append((i, out["cache"]["loaded_chunks"]))
        return out
    eng._hk_unique = reversed_unique
    recs = eng.run(N)
    assert order[:4] == [(3, 2), (2, 0), (1, 0), (0, 0)]
    assert [r["loss"] for r in recs] == losses
    _assert_same_full(eng.full_snapshot(), ref.full_snapshot())


def test_cached_engine_on_loader_batches_and_histogram_warm_up(tiny):
    """The loader's batches (uniform negatives touch every chunk each
    step, so the window holds them all), warmed up by the histogram of the
    first two batches: bit for bit the uncached engine."""
    batches = list(_loader(PLoader, PSynth, VOCAB).batches(6))
    data = lambda i: batches[i % 6]                     # noqa: E731
    ref, losses = _uncached(tiny, 6, data=data)
    cache = _cache(tiny, 16, PF.stream_id_histogram(batches[:2], VOCAB))
    eng = GREngine(tiny, data, seed=0, loss_kwargs=LK, cache=cache)
    assert [r["loss"] for r in eng.run(6)] == losses
    _assert_same_full(eng.full_snapshot(), ref.full_snapshot())


def test_cached_engine_rejects_what_it_cannot_do(tiny):
    from functools import partial
    from repro_torch.kernels.jagged_lookup import jagged_lookup
    cache = _cache(tiny, 10)
    with pytest.raises(ValueError, match="lookup_fn"):
        GREngine(tiny, _banded, cache=cache, loss_kwargs=dict(
            lookup_fn=partial(jagged_lookup, compute_dtype=torch.bfloat16)))
    other = gr_train_state(tiny.init_dense(torch.Generator(), device=CPU),
                           _init_table(tiny))
    with pytest.raises(ValueError, match="window"):
        GREngine(tiny, _banded, state=other, cache=cache)
    # a batch wider than the window's free capacity: raised, not swallowed
    small = _cache(tiny, 3)
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK, cache=small,
                   schedule="flat")
    with pytest.raises(CacheThrash, match="working set"):
        eng.run(3)
    small = _cache(tiny, 3)
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK, cache=small)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(CacheThrash):
            eng.run_resilient(4, ckpt_dir=d, ckpt_every=2)
    assert eng.recoveries == []


def test_cached_engine_obs_publishes_the_cache(tiny):
    obs = Obs()
    cache = _cache(tiny, 10)
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK, cache=cache,
                   obs=obs, peak_flops=1e12)
    recs = eng.run(6)
    snap = obs.snapshot()
    assert snap["cache_evictions"]["values"][""] == \
        cache.stats.evictions > 0
    assert snap["cache_step_misses"]["values"][""] == \
        recs[-1]["cache"]["misses"]


# --------------------------------------------------------------------------
# checkpoints and recovery
# --------------------------------------------------------------------------

def test_cached_checkpoint_round_trip_is_bitwise(tiny):
    """4 capacity-limited cached steps, full_snapshot → save → restore into
    a fresh cached engine's full_template → adopt_full_state → 4 more:
    the uncached 8-step run's losses and full state, bit for bit. The save
    makes no second host copy of the full table."""
    N = 8
    ref, losses = _uncached(tiny, N)
    e1 = GREngine(tiny, _banded, seed=0, loss_kwargs=LK,
                  cache=_cache(tiny, 10))
    first = [r["loss"] for r in e1.run(N // 2)]
    full = e1.full_snapshot()
    i = full.paths.index("table.master")
    assert full.shapes[i] == (VOCAB, tiny.cfg.d_model)
    assert full.nbytes == CKPT.host_nbytes(e1._full_layout())
    assert CKPT.snapshot(full).arrays[i] is full.arrays[i]
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, N // 2, full)
        e2 = GREngine(tiny, lambda k: _banded(N // 2 + k), seed=7,
                      loss_kwargs=LK, cache=_cache(tiny, 10))
        got, used = CKPT.restore_with_step(d, e2.full_template())
    assert used == N // 2
    _assert_same_full(got, full)
    e2.adopt_full_state(got)
    assert e2.state.pending_ids.numel() > 0
    assert torch.all(e2.state.pending_ids[1:] > e2.state.pending_ids[:-1])
    second = [r["loss"] for r in e2.run(N - N // 2)]
    assert first + second == losses
    _assert_same_full(e2.full_snapshot(), ref.full_snapshot())


@pytest.mark.parametrize("schedule", ["algorithm1", "flat"])
def test_cached_run_resilient_recovers_bitwise(tiny, schedule):
    """run_resilient with a capacity-limited cache (checkpoints every 2),
    a torn save at 4 and an injected exception at dense_fwd(6), each
    restored through the host template and adopt_full_state: every loss
    and the final full state equal the uninterrupted uncached run's."""
    N = 8
    ref, losses = _uncached(tiny, N, schedule=schedule)
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK, schedule=schedule,
                   cache=_cache(tiny, 10))
    inj = R.FaultInjector([R.FaultSpec(R.SAVE_SITE, 4, "torn_save",
                                       tear="bitflip"),
                           R.FaultSpec("dense_fwd", 6, "exception")])
    with tempfile.TemporaryDirectory() as d:
        recs = eng.run_resilient(N, ckpt_dir=d, ckpt_every=2,
                                 keep_last_n=2, injector=inj,
                                 policy=R.FaultPolicy(retries={}))
        assert CKPT.intact_steps(d)[0] == N
    assert inj.exhausted
    # the step-4 save is refused by its CRC (2 restored); dense_fwd(6)
    # follows the step-6 save
    assert [ev.restored_step for ev in eng.recoveries] == [2, 6]
    assert [r["loss"] for r in recs] == losses
    _assert_same_full(eng.full_snapshot(), ref.full_snapshot())
    assert len(eng.snapshots) >= 4


def test_cached_recovery_before_any_checkpoint_replays_from_the_anchor(tiny):
    N = 5
    ref, losses = _uncached(tiny, N)
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK,
                   cache=_cache(tiny, 10))
    inj = R.FaultInjector([R.FaultSpec("emb_bwd", 1, "exception")])
    with tempfile.TemporaryDirectory() as d:
        recs = eng.run_resilient(N, ckpt_dir=d, ckpt_every=10,
                                 final_save=False, injector=inj,
                                 policy=R.FaultPolicy(retries={}))
    assert [ev.restored_step for ev in eng.recoveries] == [0]
    assert [r["loss"] for r in recs] == losses
    _assert_same_full(eng.full_snapshot(), ref.full_snapshot())


def _cached_host_need(eng):
    """What a fresh cached ``run_resilient`` counts before its first step:
    the cache's host store, the saver's copy (all but the table, the carry
    at a row per id feature entry of the first batch, plus the window's
    rows), the checkpoint I/O buffers and the anchor (the full state as it
    is)."""
    b0 = _banded(0)
    ids = sum(b0[k].size for k in ("ids", "labels", "neg_ids"))
    full = CKPT.host_nbytes(eng._full_layout(carry_rows=min(ids, VOCAB)))
    rest = full - 2 * VOCAB * eng.cache.dim * 4
    return (eng.cache.host_nbytes + rest + eng.cache.window_nbytes
            + CKPT.IO_BUFFER_BYTES + CKPT.host_nbytes(eng._full_layout()))


def test_cached_run_resilient_counts_the_host_store(tiny, monkeypatch):
    """The memory check counts the host store (held already) and the
    cached run's copies; with exactly the copies available, a fresh run
    with faults before its first save (the anchor) and after it recovers
    bit for bit."""
    N = 8
    ref, losses = _uncached(tiny, N)
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK,
                   cache=_cache(tiny, 10))
    # the store is resident since the cache was built: the host's
    # available memory must hold the rest
    need = _cached_host_need(eng) - eng.cache.host_nbytes
    monkeypatch.setattr(CKPT, "host_available_bytes", lambda: need - 1)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(MemoryError, match="host store .* held already"):
            eng.run_resilient(2, ckpt_dir=d)
    monkeypatch.setattr(CKPT, "host_available_bytes", lambda: need)
    inj = R.FaultInjector([R.FaultSpec("dense_fwd", 1, "exception"),
                           R.FaultSpec("dense_fwd", 6, "exception")])
    with tempfile.TemporaryDirectory() as d:
        recs = eng.run_resilient(N, ckpt_dir=d, ckpt_every=4,
                                 keep_last_n=1, injector=inj,
                                 policy=R.FaultPolicy(retries={}))
    assert [ev.restored_step for ev in eng.recoveries] == [0, 4]
    assert [r["loss"] for r in recs] == losses
    _assert_same_full(eng.full_snapshot(), ref.full_snapshot())


def test_cached_restore_of_a_corrupt_step_leaves_the_store_untouched(tiny):
    """A step whose last leaf has a flipped byte is refused before the
    cache's host store is written: an explicit restore of it raises with
    the store bitwise as it was; the newest-step restore falls back to the
    previous step, which ``adopt_full_state`` loads."""
    eng = GREngine(tiny, _banded, seed=0, loss_kwargs=LK,
                   cache=_cache(tiny, 10))
    with tempfile.TemporaryDirectory() as d:
        eng.run_resilient(4, ckpt_dir=d, ckpt_every=2, keep_last_n=2)
        step2 = CKPT.restore(d, eng.full_template(), step=2)
        n = len(step2.paths)
        victim = os.path.join(d, "step_4", f"arr_{n - 1}.npy")
        data = bytearray(open(victim, "rb").read())
        data[-1] ^= 0xFF
        open(victim, "wb").write(bytes(data))
        fresh = GREngine(tiny, _banded, seed=3, loss_kwargs=LK,
                         cache=_cache(tiny, 10))
        store = (fresh.cache.host_master.copy(),
                 fresh.cache.host_accum.copy())
        with pytest.raises(CKPT.CheckpointCorrupt, match="CRC mismatch"):
            CKPT.restore(d, fresh.full_template(), step=4)
        np.testing.assert_array_equal(fresh.cache.host_master, store[0])
        np.testing.assert_array_equal(fresh.cache.host_accum, store[1])
        full, used = CKPT.restore_with_step(d, fresh.full_template())
        assert used == 2
        fresh.adopt_full_state(full)
        _assert_same_full(fresh.full_snapshot(), step2)


def test_cached_streamed_save_is_a_save_of_full_snapshot(tiny, monkeypatch):
    """The save ``run_resilient`` makes of a capacity-limited cached engine
    (``checkpoint_tree``: the table streamed from the host store, one
    chunk a piece here) writes the bytes and manifest CRC32s of a save of
    ``full_snapshot()`` taken at the same step, while the engine trains 2
    more steps (evicting and writing back) and a flush writes every dirty
    chunk back with the save in flight; the reference restores it to
    those values."""
    monkeypatch.setattr(PC, "SAVE_PIECE_BYTES",
                        CHUNK * tiny.cfg.d_model * 4)
    shift = [0]
    eng = GREngine(tiny, lambda i: _banded(i + shift[0]), seed=0,
                   loss_kwargs=LK, cache=_cache(tiny, 10))
    eng.run(4)
    full = eng.full_snapshot()
    tree = eng.checkpoint_tree()
    shift[0] = 4
    eng.run(2)                           # bands 4, 5: chunks 8-11
    i = tree.paths.index("table.master")
    leaf = tree.arrays[i]

    class FlushAfterTheFirstPiece:
        shape, dtype, nbytes = leaf.shape, leaf.dtype, leaf.nbytes
        close = leaf.close

        def pieces(self):
            for k, p in enumerate(leaf.pieces()):
                yield p
                if k == 0:
                    eng.cache.flush()

    tree.arrays[i] = FlushAfterTheFirstPiece()
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(os.path.join(d, "full"), 4, full)
        CKPT.save(os.path.join(d, "streamed"), 4, tree)
        assert eng.cache.stats.cow_chunks > 0
        a, b = (os.path.join(d, k, "step_4") for k in ("full", "streamed"))
        assert CKPT.read_manifest(a) == CKPT.read_manifest(b)
        for k in range(len(full.paths)):
            with open(os.path.join(a, f"arr_{k}.npy"), "rb") as fa, \
                    open(os.path.join(b, f"arr_{k}.npy"), "rb") as fb:
                assert fa.read() == fb.read(), full.paths[k]
        cj, _ = configs("bfloat16", n_items=VOCAB, max_seq_len=CAP)
        jb = j_bundle(cj.replace(num_negatives=N_NEG))
        key = jax.random.PRNGKey(3)
        jtmpl = JT.gr_train_state(
            jb.init_dense(key), jb.init_table(key),
            pending_slots=JT.gr_pending_slots(_banded(0)))
        j4, used = JCKPT.restore_with_step(os.path.join(d, "streamed"),
                                           jtmpl)
    assert used == 4 and int(j4.step) == 4
    arr = dict(zip(full.paths, full.arrays))
    np.testing.assert_array_equal(np.asarray(j4.table.master),
                                  arr["table.master"])
    np.testing.assert_array_equal(np.asarray(j4.table.accum),
                                  arr["table.accum"])


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

def test_all_resident_cached_engine_matches_the_reference_cached_engine():
    """The reference's cached engine and the port's, all-resident (6
    chunks of 100 rows: the window is the table), algorithm1, τ=1, 4 steps
    on the same converted weights and equal loader batches: losses and
    the full states within the training slice's fp16-shadow tolerances,
    the carry as the same set of ids."""
    tol = TOLS["fp16_shadow"]
    cj, cp = configs("float32", n_items=600, max_seq_len=32)
    cj, cp = cj.replace(num_negatives=N_NEG), cp.replace(num_negatives=N_NEG)
    key = jax.random.PRNGKey(0)
    jb = j_bundle(cj)
    dense, table = jb.init_dense(key), jb.init_table(key)
    jlk = dict(neg_mode="fused", neg_segment=SEG, fetch_dtype=jnp.float16)
    jcache = JC.CachedShadowedTable(table, capacity_chunks=6,
                                    chunk_rows=100)
    jcache.warm_up(None)
    from repro.data.loader import GRLoader as JLoader
    from repro.data.synthetic import SyntheticKuaiRand as JSynth
    jeng = JEngine(jb, _loader(JLoader, JSynth, 600), seed=0, cache=jcache,
                   loss_kwargs=jlk, schedule="algorithm1")
    jl = [r["loss"] for r in jeng.run(4)]
    jfull = jeng.full_snapshot()

    master = np.asarray(table)
    pcache = CachedShadowedTable(master, capacity_chunks=6, chunk_rows=100,
                                 device="cpu")
    pcache.warm_up(None)
    pstate = gr_train_state(
        gr_params_from_numpy(tree_numpy(dense), cp, device=CPU),
        pcache.init_window())
    peng = GREngine(GRBundle(cp), _loader(PLoader, PSynth, 600),
                    state=pstate, cache=pcache, schedule="algorithm1",
                    loss_kwargs=dict(neg_segment=SEG,
                                     fetch_dtype=torch.float16))
    pl = [r["loss"] for r in peng.run(4)]
    np.testing.assert_allclose(pl, jl, rtol=0, atol=tol["loss"])
    pfull = dict(zip(*(lambda s: (s.paths, s.arrays))(peng.full_snapshot())))
    _assert_close(pfull["table.master"], jfull.table.master, tol["master"],
                  0, "master")
    _assert_close(pfull["table.accum"], jfull.table.accum, tol["accum"], 0,
                  "accum")
    ji, jr = pending_to_numpy(torch.from_numpy(np.array(jfull.pending_ids)),
                              torch.from_numpy(np.array(
                                  jfull.pending_rows)))
    np.testing.assert_array_equal(pfull["pending_ids"], ji)
    _assert_close(pfull["pending_rows"], jr, tol["rows"], 0, "rows")


@pytest.mark.parametrize("direction", ["port_cached_to_reference",
                                       "reference_to_port_cached"])
def test_cached_checkpoints_cross_between_the_packages(direction):
    """A port checkpoint of a cached run (the loader's negatives touch every
    chunk, so the window holds them all) restores in the reference, exactly
    the uncached port run's values; a reference
    checkpoint restores into the port's cached engine (host template,
    adopt_full_state), exactly, and trains on as the port's uncached
    engine restored from it does, bit for bit."""
    jb, pb, jstate, pstate, batches, jlk, plk = _ref_pair()
    data = lambda k: (lambda i: batches[(k + i) % 6])     # noqa: E731
    V, D = pb.cfg.vocab_size, pb.cfg.d_model
    master = pstate.table.master.numpy().copy()

    def port_cached(state_dense, k):
        cache = CachedShadowedTable(master, capacity_chunks=10,
                                    chunk_rows=64, device="cpu")
        cache.warm_up(None)
        st = gr_train_state(state_dense, cache.init_window())
        return GREngine(pb, data(k), state=st, cache=cache, loss_kwargs=plk)

    with tempfile.TemporaryDirectory() as d:
        if direction == "port_cached_to_reference":
            ref = GREngine(pb, data(0), state=pstate, loss_kwargs=plk)
            ref.run(4)
            dense0 = gr_params_from_numpy(
                tree_numpy(jstate.dense), pb.cfg, device=CPU)
            eng = port_cached(dense0, 0)
            eng.run(4)
            _assert_same_full(eng.full_snapshot(), ref.full_snapshot())
            CKPT.save(d, 4, eng.full_snapshot())
            jtmpl = JT.gr_train_state(
                jb.init_dense(jax.random.PRNGKey(3)),
                jb.init_table(jax.random.PRNGKey(3)),
                pending_slots=JT.gr_pending_slots(batches[0]))
            j4, used = JCKPT.restore_with_step(d, jtmpl)
            assert used == 4
            _assert_same_state(ref.state, j4, None, "restored")
        else:
            jeng = JEngine(jb, data(0), state=jstate, loss_kwargs=jlk)
            jeng.run(4)
            JCKPT.save(d, 4, jeng.state)
            g = torch.Generator().manual_seed(3)
            eng = port_cached(pb.init_dense(g, device=CPU), 4)
            full, used = CKPT.restore_with_step(d, eng.full_template())
            eng.adopt_full_state(full)
            g = torch.Generator().manual_seed(3)
            ptmpl = gr_train_state(pb.init_dense(g, device=CPU),
                                   pb.init_table(g, device=CPU))
            p4 = CKPT.restore(d, ptmpl)
            assert used == 4
            _assert_same_full(eng.full_snapshot(), CKPT.snapshot(p4))
            _assert_same_state(p4, jeng.state, None, "restored")
            ref = GREngine(pb, data(4), state=p4, loss_kwargs=plk)
            assert [r["loss"] for r in eng.run(4)] == \
                [r["loss"] for r in ref.run(4)]
            _assert_same_full(eng.full_snapshot(), ref.full_snapshot())
