"""Host-offloaded, frequency-aware embedding cache (§4.3.1 regime): the port
of ``repro.embedding.cache``.

The fp32 master, fp16 shadow and AdaGrad accumulator of a production GR
vocabulary outgrow the card (42.9 GB at vocab 2²², d 1024).
:class:`CachedShadowedTable` keeps the full table in host RAM and a
*window* of hot row-chunks on the card: a plain
:class:`~repro_torch.embedding.tables.ShadowedTable` of
``capacity_chunks * chunk_rows`` rows, logically ``(capacity_chunks,
chunk_rows, D)``. Every consumer of a ShadowedTable (the staged train step,
the fused negative kernels, ``adagrad_apply_unique``) runs on it unchanged;
the one new moving part is the id → window-row translation on the host,
where the batch already is.

Chunk manager (host-side numpy, one lock), the reference's semantics:

  * id → chunk is ``id // chunk_rows``; chunk → slot and slot → chunk maps
    track residency (−1 = absent / free).
  * Admission and eviction are frequency-weighted LFU: per-chunk counters
    of candidate occurrences, seeded by :meth:`warm_up` from an id
    histogram (:func:`repro_torch.data.freq.stream_id_histogram`), stable
    sorts, so ties admit in chunk order. Eviction takes the coldest
    *unpinned* resident chunk.
  * A batch's chunks are pinned from :meth:`prepare_batch` to :meth:`release`
    (or, with its τ=1 pairs pending, :meth:`defer_release` →
    :meth:`release_pending`), so no swap pulls a row from under an
    in-flight gather or a landing still to come. Pins are taken before
    slots are assigned: a batch never evicts its own hit chunks.
  * Row-sparse AdaGrad is the only mutation, so writeback is row-sparse
    and deferred to eviction: a released batch marks its chunks dirty with
    the rows it touched, and evicting a dirty chunk copies only those rows
    back (a chunk dirty without a row record writes back whole).

What the port does differently, and why:

  * The window is **updated in place** (two tables do not fit where the
    cache is needed): :meth:`splice` writes a plan's chunks into the
    chunk-major views of master, accumulator and shadow, the shadow cast
    from the spliced master rows, so ``shadow == master.half()`` stays
    bitwise. The window is written only on the caller's (main) stream.
  * Three streams. :meth:`prepare_batch` runs on a worker thread (the
    engine's ``unique`` stage). Under the lock it only decides: it picks
    the victims and claims a dirty victim's rows as a writeback in
    flight. Outside the lock the victim's rows are read on the cache's
    writeback stream after it waits on the event the main stream recorded
    when the victim's last batch was released (its landing is enqueued by
    then), and the worker waits for that copy before it updates the host
    store; :meth:`prepare_batch` returns only then, so a later splice into
    the victim's slot, enqueued on the main stream, cannot overwrite rows
    not yet saved. A prepare that admits a chunk still being written back
    waits for it before it reads the chunk's host rows, and
    :meth:`materialize`, :meth:`flush` and :meth:`adopt` wait for every
    writeback in flight. The missing chunks are copied host → pinned
    staging → card on the cache's copy stream, and the worker waits for
    the copy too: the staged tensors are complete when
    :meth:`prepare_batch` returns, and :meth:`splice` marks them used by
    the main stream (``record_stream``).
  * Prepares run concurrently (the pipeline's prologue starts four), so a
    later batch's may admit a chunk that an earlier batch then hits and
    gathers before the later batch's splice. Each admission is a
    :class:`ChunkLoad` until spliced, and a batch's plan names every load
    of a chunk it reads: its splice lands them first, whichever prepare
    made them (the reference splices only the batch's own chunks).
  * No host sort: the engine hands :meth:`prepare_batch` the batch's raw id
    features; the chunk weights are one ``np.bincount`` of
    ``id // chunk_rows`` over the clipped candidates and the touched rows a
    boolean mask, the same numbers the reference takes from
    ``host_unique_candidates``' sorted runs.
  * The τ=1 carry is the port's compact one (unique slot ids ascending):
    :meth:`globalize_pending_pairs` maps it to global ids in ascending
    order, bit for bit the uncached engine's carry.
  * :meth:`materialize` returns the full table as host numpy arrays (no
    second copy when a checkpoint saves them).
  * A checkpoint does not materialize the table: :meth:`table_snapshot`
    gives the master and accumulator as two leaves the save streams from
    the host store, overlaid with the window's dirty chunks (copied to the
    host when it is taken). The save runs on the saver's thread while
    training goes on, so a writeback (or :meth:`flush`) that would
    overwrite store rows the save has not read yet copies that chunk's old
    rows aside first (copy-on-write by chunk); :meth:`adopt` waits for
    every save in flight.

Bit identity: translation only permutes where rows live. The gathers, the
sorted run-sums (each run summed in stable-sort order from zero, wherever
it sits in the list) and the per-row AdaGrad do not depend on where a row
lives, so a cached engine equals the uncached one bit for bit, capacity
limited or not.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.embedding.tables import ShadowedTable

#: Chunks one window read or fill moves at a time (bounds the device and
#: host temporaries: 64 chunks of 1024 × 1024 fp32 rows are 256 MB).
CHUNKS_PER_COPY = 64

#: Bytes of the host store a streamed save reads at a time (whole chunks).
SAVE_PIECE_BYTES = 64 << 20


@dataclass
class CacheStats:
    """Cumulative counters (id-occurrence-weighted hits/misses)."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    writebacks: int = 0
    swap_in_bytes: int = 0
    swap_out_bytes: int = 0
    warmup_bytes: int = 0
    # row-sparse writeback: rows copied back against the rows a
    # chunk-granular writeback would have copied
    writeback_rows_dirty: int = 0
    writeback_rows_total: int = 0
    # chunks a writeback or flush copied aside for a save in flight
    cow_chunks: int = 0

    @property
    def hit_rate(self) -> float:
        seen = self.hits + self.misses
        return self.hits / seen if seen else 0.0


class StagedChunks(NamedTuple):
    """Chunks copied to the window's device, waiting to be spliced."""
    slots: torch.Tensor             # (n,) int64 window chunk slots
    master: torch.Tensor            # (n, chunk_rows, D) fp32
    accum: torch.Tensor             # (n, chunk_rows, D) fp32
    event: Optional[torch.cuda.Event]   # the copies' end (None on the CPU)


class ChunkLoad:
    """The chunks one :meth:`CachedShadowedTable.prepare_batch` admitted,
    from their admission (under the lock) to their splice: ``done`` is set
    once ``staged`` (or ``error``) is there."""

    def __init__(self, chunks: np.ndarray):
        self.chunks = chunks
        self.done = threading.Event()
        self.staged: Optional[StagedChunks] = None
        self.error: Optional[BaseException] = None
        self.spliced = False


class _Writeback:
    """Dirty victims' rows on their way from the window to the host
    store: claimed under the lock (the chunks' dirty flags cleared, their
    slots given to the missing chunks), copied outside it; ``done`` is set
    once the host store holds them (or ``error`` is there)."""

    def __init__(self, chunks: np.ndarray, host_rows: np.ndarray,
                 win_rows: np.ndarray, events, saves):
        self.chunks = chunks
        self.host_rows = host_rows
        self.win_rows = win_rows
        self.events = events
        self.saves = saves            # the saves in flight at the claim
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class _TableSave:
    """One save's view of the full table as :meth:`CachedShadowedTable.
    table_snapshot` took it: the host store, the window's dirty chunks at
    that moment (``overlay``, copied to the host) and the chunks whose store
    rows were overwritten since (their old rows copied aside first). Each
    of the two leaves (0 master, 1 accumulator) reads the store once, a
    piece of whole chunks at a time, and ``passed`` records how far: a
    chunk is copied aside only while a leaf still has it ahead."""

    def __init__(self, cache: "CachedShadowedTable",
                 overlay: Dict[int, Tuple[np.ndarray, np.ndarray]]):
        self.cache = cache
        self.overlay = overlay
        self.passed = [0, 0]
        self.open = [True, True]
        self.started = [False, False]
        self.copied_aside = 0
        self.lock = threading.Lock()

    def preserve(self, chunks: np.ndarray) -> None:
        """Before the store rows of ``chunks`` are overwritten: copy aside
        the old rows of those an open leaf has not read yet."""
        C, R = self.cache, self.cache.chunk_rows
        with self.lock:
            ahead = [p for p, o in zip(self.passed, self.open) if o]
            if not ahead:
                return
            for c in np.asarray(chunks).tolist():
                if c >= min(ahead) and c not in self.overlay:
                    rows = slice(c * R, (c + 1) * R)
                    self.overlay[c] = (C.host_master[rows].copy(),
                                       C.host_accum[rows].copy())
                    self.copied_aside += 1

    def pieces(self, which: int):
        """Leaf ``which``'s rows [0, vocab) in pieces of whole chunks (the
        last cut at the vocab), each valid until the next is taken."""
        C, R = self.cache, self.cache.chunk_rows
        with self.lock:
            if self.started[which] or not self.open[which]:
                raise RuntimeError("a streamed table leaf is read once")
            self.started[which] = True
        store = C.host_master if which == 0 else C.host_accum
        k = max(1, SAVE_PIECE_BYTES // (R * C.dim * 4))
        buf = np.empty((k * R, C.dim), np.float32)
        for c0 in range(0, C.num_chunks, k):
            c1 = min(c0 + k, C.num_chunks)
            n = min(c1 * R, C.vocab) - c0 * R
            out = buf[:n]
            with self.lock:
                np.copyto(out, store[c0 * R:c0 * R + n])
                for c in range(c0, c1):
                    old = self.overlay.get(c)
                    if old is not None:
                        lo = (c - c0) * R
                        hi = min(lo + R, n)
                        out[lo:hi] = old[which][:hi - lo]
                self.passed[which] = c1
            yield out

    def close(self, which: int) -> None:
        with self.lock:
            if not self.open[which]:
                return
            self.open[which] = False
            done = not any(self.open)
            if done:
                self.overlay = {}
        if done:
            self.cache._end_save(self)


class _StoreLeaf:
    """The master (``which`` 0) or accumulator (1) leaf of a
    :class:`_TableSave`: ``(vocab, dim)`` float32, streamed once."""

    def __init__(self, save: _TableSave, which: int):
        self._save, self._which = save, which
        C = save.cache
        self.shape = (C.vocab, C.dim)
        self.dtype = np.dtype(np.float32)
        self.nbytes = C.vocab * C.dim * 4

    def pieces(self):
        return self._save.pieces(self._which)

    def close(self) -> None:
        self._save.close(self._which)


class PrefetchPlan(NamedTuple):
    """What :meth:`CachedShadowedTable.splice` lands before a batch's first
    gather: the loads of the chunks the batch reads that are not in the
    window yet — its own prepare's, and those of other in-flight prepares
    that admitted a chunk the batch hits (prepares run concurrently, so a
    later batch's may admit a chunk before an earlier batch's runs)."""
    loads: Tuple[ChunkLoad, ...]


class CacheThrash(RuntimeError):
    """A batch needs more chunks than capacity minus the pinned ones: the
    window is too small for the in-flight working set (shrink the batch,
    raise ``capacity_chunks``, or reduce the pipeline depth)."""


def _copy_rows_to_host(dst: np.ndarray, src) -> None:
    """``dst[:len(src)] = src`` as fp32, for a numpy array, a tensor on any
    device, or a checkpoint's leaf file (read straight into ``dst``), in
    pieces of ~64 MB (no full-size host temporary)."""
    if hasattr(src, "read_into"):
        if src.dtype == dst.dtype:
            src.read_into(dst[:src.shape[0]])
            return
        lo = 0
        for piece in src.pieces():
            dst[lo:lo + len(piece)] = piece
            lo += len(piece)
        return
    if not isinstance(src, torch.Tensor):
        dst[:len(src)] = np.asarray(src, np.float32)
        return
    src = src.detach()
    step = max(1, (64 << 20) // max(1, src.shape[1] * 4))
    n = src.shape[0]
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        torch.from_numpy(dst[lo:hi]).copy_(src[lo:hi])


class CachedShadowedTable:
    """Host-resident full table + a hot-chunk window on ``device``.

    ``master`` is the full ``(V, D)`` table (numpy or a tensor anywhere;
    copied into host RAM as fp32, padded to whole chunks); ``accum`` the
    AdaGrad accumulator (default zeros). :meth:`init_window` builds the
    window after :meth:`warm_up`; the engine then keeps it current through
    :meth:`prepare_batch` / :meth:`splice` and the release calls, and
    :meth:`materialize` reassembles the full table for checkpoints.
    ``device`` None means the card.
    """

    def __init__(self, master, *, capacity_chunks: int,
                 chunk_rows: int = 1024, qdtype=torch.float16, accum=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if len(master.shape) != 2:
            raise ValueError(f"master must be (V, D), got "
                             f"{tuple(master.shape)}")
        if capacity_chunks < 1 or chunk_rows < 1:
            raise ValueError("capacity_chunks and chunk_rows must be >= 1")
        self.vocab, self.dim = int(master.shape[0]), int(master.shape[1])
        self.chunk_rows = int(chunk_rows)
        self.capacity_chunks = int(capacity_chunks)
        self.num_chunks = -(-self.vocab // self.chunk_rows)   # ceil
        self.qdtype = qdtype
        vpad = self.num_chunks * self.chunk_rows
        # every page written once (np.zeros maps a page on its first
        # write), so the host's available memory shows the whole store
        self.host_master = np.zeros((vpad, self.dim), np.float32)
        _copy_rows_to_host(self.host_master, master)
        self.host_master[self.vocab:] = 0.0
        self.host_accum = np.zeros((vpad, self.dim), np.float32)
        if accum is not None:
            _copy_rows_to_host(self.host_accum, accum)
            self.host_accum[self.vocab:] = 0.0
        else:
            self.host_accum.fill(0.0)
        self.chunk_slot = np.full(self.num_chunks, -1, np.int64)
        self.slot_chunk = np.full(self.capacity_chunks, -1, np.int64)
        self.freq = np.zeros(self.num_chunks, np.int64)
        self.dirty = np.zeros(self.num_chunks, bool)
        # chunk id → (chunk_rows,) bool mask of touched rows, for dirty
        # chunks with a recorded touch set
        self.dirty_rows: Dict[int, np.ndarray] = {}
        self.pins = np.zeros(self.num_chunks, np.int64)
        self.stats = CacheStats()
        # batch → its chunks (ascending) and their touched-row masks
        self._batch_chunks: Dict[int, np.ndarray] = {}
        self._batch_rows: Dict[int, np.ndarray] = {}
        self._pending_chunks: Optional[np.ndarray] = None
        self._pending_rows: Optional[np.ndarray] = None
        self._window: Optional[ShadowedTable] = None
        cuda = self.device.type == "cuda"
        # host → card copies, and card → host writebacks (a writeback does
        # not queue behind other prefetches' copies)
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._wb_stream = torch.cuda.Stream(self.device) if cuda else None
        # dirty chunk → the main-stream event recorded when it was last
        # released (its landing enqueued): a writeback reads after it
        self._landed: Dict[int, torch.cuda.Event] = {}
        # chunk → its load, from admission to splice
        self._loading: Dict[int, ChunkLoad] = {}
        # victim chunk → its writeback, from its claim to the host store;
        # chunks whose writeback failed (their rows are lost until adopt)
        self._draining: Dict[int, _Writeback] = {}
        self._lost: set = set()
        # saves in flight (table_snapshot to the close of both leaves)
        self._saves: set = set()
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)

    # -- capacity accounting ------------------------------------------------
    @property
    def rows(self) -> int:
        """Device-resident row budget (window height)."""
        return self.capacity_chunks * self.chunk_rows

    @property
    def window(self) -> Optional[ShadowedTable]:
        """The window (None before :meth:`init_window`); always the same
        tensors, updated in place."""
        return self._window

    @property
    def host_nbytes(self) -> int:
        """Bytes of the host store (master and accumulator)."""
        return int(self.host_master.nbytes + self.host_accum.nbytes)

    @property
    def window_nbytes(self) -> int:
        """Bytes of the window's master and accumulator (the most a
        :meth:`table_snapshot` copies to the host)."""
        return 2 * self.rows * self.dim * 4

    # -- warm-up / window ---------------------------------------------------
    def warm_up(self, hist=None) -> np.ndarray:
        """Admit the ``capacity_chunks`` hottest chunks by histogram.

        ``hist`` is a ``(vocab,)`` id histogram; its counts seed the LFU
        counters. ``None`` admits chunks in id order (with ``capacity_chunks
        >= num_chunks`` the identity map: the window is the full table).
        Returns the admitted chunk ids. Must run before any window exists.
        """
        with self._lock:
            if self._window is not None or self._batch_chunks:
                raise RuntimeError("warm_up must precede init_window/prepare")
            if hist is not None:
                h = np.zeros(self.num_chunks * self.chunk_rows, np.int64)
                h[:self.vocab] = np.asarray(hist, np.int64)[:self.vocab]
                self.freq += h.reshape(self.num_chunks,
                                       self.chunk_rows).sum(axis=1)
                # stable sort: ties admit in chunk-id order
                order = np.argsort(-self.freq, kind="stable")
            else:
                order = np.arange(self.num_chunks)
            admit = np.sort(order[:min(self.capacity_chunks,
                                       self.num_chunks)])
            self.chunk_slot[:] = -1
            self.slot_chunk[:] = -1
            self.chunk_slot[admit] = np.arange(admit.size)
            self.slot_chunk[:admit.size] = admit
            return admit

    def init_window(self) -> ShadowedTable:
        """Allocate the window on the device (once) and fill it from the
        host store at the current residency."""
        with self._lock:
            if self._window is None:
                kw = dict(device=self.device)
                master = torch.zeros((self.rows, self.dim),
                                     dtype=torch.float32, **kw)
                self._window = ShadowedTable(
                    master=master,
                    shadow=(None if self.qdtype is None else torch.zeros(
                        (self.rows, self.dim), dtype=self.qdtype, **kw)),
                    accum=torch.zeros_like(master))
            self._fill_window_locked()
            return self._window

    def _chunk_view(self, t: torch.Tensor) -> torch.Tensor:
        return t.view(-1, self.chunk_rows, self.dim)

    def _fill_window_locked(self) -> None:
        """Window := the host rows of the resident chunks, zeros in free
        slots, shadow cast from the master (on the caller's stream)."""
        self._await_drains_locked()
        win = self._window
        win.master.zero_()
        win.accum.zero_()
        res = np.flatnonzero(self.chunk_slot >= 0)
        hm = self.host_master.reshape(-1, self.chunk_rows, self.dim)
        ha = self.host_accum.reshape(-1, self.chunk_rows, self.dim)
        for lo in range(0, res.size, CHUNKS_PER_COPY):
            c = res[lo:lo + CHUNKS_PER_COPY]
            s = torch.from_numpy(self.chunk_slot[c]).to(self.device)
            for dst, src in ((win.master, hm), (win.accum, ha)):
                self._chunk_view(dst)[s] = torch.from_numpy(
                    np.take(src, c, axis=0)).to(self.device)
        self.stats.warmup_bytes += int(res.size * self.chunk_rows
                                       * self.dim * 4 * 2)
        if win.shadow is not None:
            win.shadow.copy_(win.master)

    # -- id translation -----------------------------------------------------
    def translate(self, ids) -> np.ndarray:
        """Global ids → window row ids (host-side numpy, int32).

        Ids are clamped to ``[0, vocab)`` first, the clip every table read
        applies. Every referenced chunk must be resident (call after
        :meth:`prepare_batch` for the batch)."""
        a = np.clip(np.asarray(ids, np.int64), 0, self.vocab - 1)
        slots = self.chunk_slot[a // self.chunk_rows]
        if (slots < 0).any():
            missing = np.unique(a[slots < 0] // self.chunk_rows)
            raise KeyError(f"non-resident chunks {missing.tolist()} — "
                           "prepare_batch() the batch before translating")
        out = slots * self.chunk_rows + a % self.chunk_rows
        return out.astype(np.int32).reshape(np.shape(ids))

    def slotize_pending(self, pending_ids) -> np.ndarray:
        """:meth:`translate` preserving the −1 empty-pair sentinel."""
        p = np.asarray(pending_ids, np.int64)
        out = np.full(p.shape, -1, np.int32)
        live = p >= 0
        if live.any():
            out[live] = self.translate(p[live])
        return out

    def globalize_pending(self, slot_ids) -> np.ndarray:
        """Window row ids → global ids (−1 sentinel preserved)."""
        s = np.asarray(slot_ids, np.int64)
        out = np.full(s.shape, -1, np.int32)
        live = s >= 0
        if live.any():
            chunks = self.slot_chunk[s[live] // self.chunk_rows]
            if (chunks < 0).any():
                raise KeyError("slot id maps to a free slot")
            out[live] = (chunks * self.chunk_rows
                         + s[live] % self.chunk_rows).astype(np.int32)
        return out

    def globalize_pending_pairs(self, slot_ids, rows
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """The port's compact τ=1 carry in window space (unique slot ids,
        (u, D) rows; tensors or arrays) → (global ids int32 ascending, their
        rows fp32) on the host: bit for bit the uncached engine's carry.
        Translation is order-preserving only within a chunk, so the rows
        are permuted into global-id order."""
        s = (slot_ids.detach().cpu().numpy() if isinstance(
            slot_ids, torch.Tensor) else np.asarray(slot_ids))
        r = (rows.detach().cpu().numpy() if isinstance(rows, torch.Tensor)
             else np.asarray(rows, np.float32))
        s = s.astype(np.int64).reshape(-1)
        if (s < 0).any():
            raise ValueError("the port's carry holds slot ids >= 0 only")
        gids = self.globalize_pending(s)
        order = np.argsort(gids, kind="stable")
        return gids[order], np.ascontiguousarray(r[order])

    # -- per-batch protocol -------------------------------------------------
    def chunk_candidates(self, id_arrays: Sequence
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A batch's table reads (its raw id features) → (chunks ascending,
        their weights = clipped candidate occurrences, their touched-row
        masks (n, chunk_rows) bool), without sorting the candidates: one
        ``np.bincount`` and one boolean scatter."""
        cand = np.concatenate([np.asarray(a).reshape(-1)
                               for a in id_arrays]).astype(np.int64)
        np.clip(cand, 0, self.vocab - 1, out=cand)
        w = np.bincount(cand // self.chunk_rows, minlength=self.num_chunks)
        chunks = np.flatnonzero(w)
        touched = np.zeros(self.num_chunks * self.chunk_rows, bool)
        touched[cand] = True
        return (chunks, w[chunks],
                touched.reshape(self.num_chunks, self.chunk_rows)[chunks])

    def prepare_batch(self, batch: int, id_arrays: Sequence
                      ) -> Tuple[Optional[PrefetchPlan], Dict[str, float]]:
        """Pin batch ``batch``'s chunks, swapping in the missing ones, from
        its table reads (raw id features; the reference's ``prepare`` on
        the unique ids and their counts, without the host sort).

        Returns ``(plan, step_stats)``: the plan names the loads
        :meth:`splice` must land before the batch's first gather (None when
        every chunk the batch reads is in the window). Dirty victims are
        written back to the host store, and the missing chunks copied to
        the device, before this returns."""
        chunks, weight, rows = self.chunk_candidates(id_arrays)
        slots = own = drain = None
        waits = []
        with self._lock:
            prev = self._batch_chunks.pop(batch, None)
            if prev is not None:            # stage retry: re-prepare
                self.pins[prev] -= 1
                self._batch_rows.pop(batch, None)
            self.freq[chunks] += weight
            resident = self.chunk_slot[chunks] >= 0
            hits = int(weight[resident].sum())
            misses = int(weight[~resident].sum())
            self.stats.hits += hits
            self.stats.misses += misses
            missing = chunks[~resident]
            evicted = swap_in = swap_out = 0
            # pin BEFORE assigning slots: the batch's hit chunks must not
            # be eviction victims for its own missing chunks
            self.pins[chunks] += 1
            self._batch_chunks[batch] = chunks
            self._batch_rows[batch] = rows
            # resident chunks another prepare admitted and no splice has
            # landed yet: this batch's splice lands them first
            deps = {id(ld): ld for ld in (self._loading.get(c) for c in
                                          chunks[resident].tolist())
                    if ld is not None}
            if missing.size:
                out0 = self.stats.swap_out_bytes
                try:
                    slots, evicted, drain = self._assign_slots_locked(
                        missing)
                except CacheThrash:
                    self.pins[chunks] -= 1      # unwind: nothing resident
                    del self._batch_chunks[batch]
                    del self._batch_rows[batch]
                    raise
                swap_out = self.stats.swap_out_bytes - out0
                row_bytes = 2 * 4 + (0 if self.qdtype is None else
                                     torch.empty((), dtype=self.qdtype
                                                 ).element_size())
                swap_in = int(missing.size * self.chunk_rows * self.dim
                              * row_bytes)
                self.stats.swap_in_bytes += swap_in
                own = ChunkLoad(missing)
                deps[id(own)] = own
                for c in missing.tolist():
                    self._loading[c] = own
                # another prepare's victims this batch admits again: their
                # host rows are read once that writeback is done
                waits = list({id(w): w for w in (
                    self._draining.get(c) for c in missing.tolist())
                    if w is not None}.values())
        if own is not None:
            # outside the lock: the victims' slots hold rows no batch in
            # flight reads or writes (unpinned), and the missing chunks
            # are pinned by this batch and were not resident, so no other
            # thread writes their host rows
            try:
                if drain is not None:
                    self._write_back(drain)
                for w in waits:
                    w.done.wait()
                    if w.error is not None:
                        raise RuntimeError("the writeback of a chunk this "
                                           "batch admits failed") from w.error
                own.staged = self._stage(missing, slots)
            except BaseException as e:
                own.error = e
                raise
            finally:
                own.done.set()
        plan = PrefetchPlan(tuple(deps.values())) if deps else None
        step = {"hits": hits, "misses": misses,
                "hit_rate": hits / max(hits + misses, 1),
                "loaded_chunks": int(missing.size),
                "evicted_chunks": evicted,
                "swap_in_bytes": swap_in, "swap_out_bytes": swap_out}
        return plan, step

    def _thrash_message(self, need: int, free: int, evictable: int) -> str:
        pinned = int((self.pins > 0).sum())
        held = sorted(self._batch_chunks)
        pend = (" and the τ=1 pending batch's "
                f"{self._pending_chunks.size} chunks"
                if self._pending_chunks is not None else "")
        return (f"need {need} chunk slots but only {free} free + {evictable} "
                f"evictable of {self.capacity_chunks}: the in-flight "
                f"working set pins {pinned} chunks (batches {held}{pend}); "
                f"raise capacity_chunks, shrink the batch or the pipeline "
                f"depth")

    def _assign_slots_locked(self, missing: np.ndarray
                             ) -> Tuple[np.ndarray, int,
                                        Optional[_Writeback]]:
        free = np.flatnonzero(self.slot_chunk < 0)
        evicted = 0
        drain = None
        if free.size < missing.size:
            need = missing.size - free.size
            cand = np.flatnonzero((self.chunk_slot >= 0) & (self.pins == 0))
            if cand.size < need:
                raise CacheThrash(self._thrash_message(
                    missing.size, free.size, cand.size))
            # frequency-weighted LFU: evict the coldest unpinned chunks
            victims = cand[np.argsort(self.freq[cand], kind="stable")][:need]
            drain = self._claim_writeback_locked(victims[self.dirty[victims]])
            self.slot_chunk[self.chunk_slot[victims]] = -1
            self.chunk_slot[victims] = -1
            evicted = int(victims.size)
            self.stats.evictions += evicted
            free = np.flatnonzero(self.slot_chunk < 0)
        slots = np.sort(free[:missing.size])
        self.chunk_slot[missing] = slots
        self.slot_chunk[slots] = missing
        return slots, evicted, drain

    def _claim_writeback_locked(self, chunks: np.ndarray
                                ) -> Optional[_Writeback]:
        """Claim the dirty ``chunks``' touched rows (whole chunks without a
        row record) for a writeback from the window to the host store:
        their dirty flags cleared and the stats counted here,
        :meth:`_write_back` copies them outside the lock."""
        if chunks.size == 0:
            return None
        if self._window is None:
            raise RuntimeError("dirty chunk eviction before any window "
                               "exists")
        R = self.chunk_rows
        host_rows, win_rows, events = [], [], []
        for c in chunks.tolist():
            mask = self.dirty_rows.pop(c, None)
            rows = np.flatnonzero(mask) if mask is not None else np.arange(R)
            self.stats.writeback_rows_dirty += int(rows.size)
            self.stats.writeback_rows_total += R
            host_rows.append(c * R + rows)
            win_rows.append(int(self.chunk_slot[c]) * R + rows)
            events.append(self._landed.pop(c, None))
            self.dirty[c] = False
            self.stats.writebacks += 1
        g = np.concatenate(host_rows)
        self.stats.swap_out_bytes += int(g.size * self.dim * 4 * 2)
        wb = _Writeback(chunks, g, np.concatenate(win_rows), events,
                        list(self._saves))
        for c in chunks.tolist():
            self._draining[c] = wb
        return wb

    def _write_back(self, wb: _Writeback) -> None:
        """A claimed writeback, outside the lock: the rows to the host
        store, then the chunks published as drained."""
        try:
            if wb.host_rows.size:
                m, a = self._read_rows(wb.win_rows, wb.events)
                for save in wb.saves:
                    save.preserve(wb.chunks)
                self.host_master[wb.host_rows] = m
                self.host_accum[wb.host_rows] = a
        except BaseException as e:
            wb.error = e
            raise
        finally:
            with self._lock:
                for c in wb.chunks.tolist():
                    if self._draining.get(c) is wb:
                        del self._draining[c]
                        if wb.error is not None:
                            self._lost.add(c)
                wb.done.set()
                self._drained.notify_all()

    def _await_drains_locked(self) -> None:
        """Under the lock: wait until no writeback is in flight, so the
        host store holds every row not dirty in the window."""
        while self._draining:
            self._drained.wait()

    def _read_rows(self, idx: np.ndarray, events) -> Tuple[np.ndarray,
                                                            np.ndarray]:
        """Window rows ``idx`` of master and accumulator on the host. On
        the card: on the cache's writeback stream, after the given landing
        events, complete when this returns."""
        win = self._window
        if self._wb_stream is None:
            t = torch.from_numpy(idx)
            return (win.master.index_select(0, t).numpy(),
                    win.accum.index_select(0, t).numpy())
        wbs = self._wb_stream
        with torch.cuda.device(self.device), torch.cuda.stream(wbs):
            for ev in {id(e): e for e in events if e is not None}.values():
                wbs.wait_event(ev)
            t = torch.from_numpy(idx).to(self.device)
            # .cpu() into pageable memory waits for this stream
            m = win.master.index_select(0, t).cpu()
            a = win.accum.index_select(0, t).cpu()
        return m.numpy(), a.numpy()

    def _stage(self, missing: np.ndarray, slots: np.ndarray
               ) -> StagedChunks:
        """The missing chunks' host rows on the window's device: through
        pinned staging buffers on the cache's stream, complete on return."""
        shape = (missing.size, self.chunk_rows, self.dim)
        hm = self.host_master.reshape(-1, self.chunk_rows, self.dim)
        ha = self.host_accum.reshape(-1, self.chunk_rows, self.dim)
        s = torch.from_numpy(slots.astype(np.int64))
        if self._stream is None:
            return StagedChunks(s, torch.from_numpy(np.take(hm, missing, 0)),
                                torch.from_numpy(np.take(ha, missing, 0)),
                                None)
        pm = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        pa = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        np.take(hm, missing, axis=0, out=pm.numpy())
        np.take(ha, missing, axis=0, out=pa.numpy())
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            plan = StagedChunks(
                s.pin_memory().to(self.device, non_blocking=True),
                pm.to(self.device, non_blocking=True),
                pa.to(self.device, non_blocking=True), torch.cuda.Event())
            plan.event.record(self._stream)
        # the staging buffers stay alive (and unreused) until the copies end
        plan.event.synchronize()
        return plan

    def splice(self, table: ShadowedTable,
               plan: Optional[PrefetchPlan]) -> ShadowedTable:
        """Land a plan's loads not landed yet into the window, in place, on
        the caller's stream (which first waits on each load's copies; the
        host waits for a load another thread is still staging). The shadow
        rows are cast from the spliced master rows, so ``shadow ==
        master.to(qdtype)`` stays bitwise. The slots belong to chunks no
        batch has read or written since they were admitted: they were not
        resident, and everything in flight is pinned."""
        if plan is None:
            return table
        for ld in plan.loads:
            ld.done.wait()
            if ld.error is not None:
                raise RuntimeError("a chunk prefetch this batch reads "
                                   "from failed") from ld.error
            with self._lock:
                if ld.spliced:
                    continue
                ld.spliced = True
                for c in ld.chunks.tolist():
                    if self._loading.get(c) is ld:
                        del self._loading[c]
            self._splice_staged(table, ld.staged)
        return table

    def _splice_staged(self, table: ShadowedTable, st: StagedChunks) -> None:
        if st.event is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(st.event)
            for t in (st.slots, st.master, st.accum):
                t.record_stream(main)
        self._chunk_view(table.master)[st.slots] = st.master
        self._chunk_view(table.accum)[st.slots] = st.accum
        if table.shadow is not None and \
                table.shadow.shape[0] == table.master.shape[0]:
            self._chunk_view(table.shadow)[st.slots] = st.master.to(
                table.shadow.dtype)

    def _mark_rows_dirty_locked(self, chunks: np.ndarray,
                                rows: np.ndarray) -> None:
        """Fold a batch's touched rows into the per-chunk masks."""
        for j, c in enumerate(chunks.tolist()):
            mask = self.dirty_rows.get(c)
            if mask is None:
                # a chunk already dirty WITHOUT a mask stays whole-chunk
                if self.dirty[c]:
                    continue
                mask = self.dirty_rows[c] = np.zeros(self.chunk_rows, bool)
            mask |= rows[j]

    def _mark_dirty_locked(self, chunks: np.ndarray,
                           rows: np.ndarray) -> None:
        self._mark_rows_dirty_locked(chunks, rows)
        self.dirty[chunks] = True
        if self._stream is not None and chunks.size:
            # the caller's stream has the landing enqueued: a writeback of
            # these chunks reads after this event
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            for c in chunks.tolist():
                self._landed[c] = ev

    def release(self, batch: int, *, dirty: bool = True) -> None:
        """Unpin a batch whose sparse update has been enqueued (``dirty``)
        or that was dropped without touching the table. Call it on the
        stream that ran the landing."""
        with self._lock:
            chunks = self._batch_chunks.pop(batch, None)
            if chunks is None:
                return
            rows = self._batch_rows.pop(batch)
            self.pins[chunks] -= 1
            if dirty:
                self._mark_dirty_locked(chunks, rows)

    def defer_release(self, batch: int) -> None:
        """τ=1: the batch's pairs are pending — keep its chunks pinned
        until :meth:`release_pending` (the deferred landing)."""
        with self._lock:
            if batch not in self._batch_chunks:
                return
            if self._pending_chunks is not None:
                raise RuntimeError("two batches with pending pairs — the "
                                   "τ=1 carry holds at most one")
            self._pending_chunks = self._batch_chunks.pop(batch)
            self._pending_rows = self._batch_rows.pop(batch)

    def release_pending(self) -> None:
        """The deferred τ=1 pairs' landing is enqueued: unpin + mark
        dirty."""
        with self._lock:
            chunks, self._pending_chunks = self._pending_chunks, None
            rows, self._pending_rows = self._pending_rows, None
            if chunks is not None:
                self.pins[chunks] -= 1
                self._mark_dirty_locked(chunks, rows)

    def reset_pins(self) -> None:
        """Drop every in-flight pin (crash recovery: the run that took them
        is gone; dirty flags are kept)."""
        with self._lock:
            self._batch_chunks.clear()
            self._batch_rows.clear()
            self._pending_chunks = None
            self._pending_rows = None
            self._loading.clear()
            self.pins[:] = 0

    # -- full-table assembly (checkpointing) --------------------------------
    def _read_chunks(self, t: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """Whole chunk slots of a window tensor on the host, on the
        caller's stream (after its enqueued work)."""
        s = torch.from_numpy(slots.astype(np.int64)).to(t.device)
        return self._chunk_view(t)[s].cpu().numpy()

    def materialize(self) -> ShadowedTable:
        """The full ``(V, D)`` table on the host: a copy of the host store
        overlaid with the window's dirty chunks. Non-mutating. Master and
        accumulator are numpy arrays; the shadow is a 0-row placeholder
        (checkpoints never store it)."""
        with self._lock:
            self._await_drains_locked()
            m, a = self._flush_into_locked(self.host_master.copy(),
                                           self.host_accum.copy())
        shadow = (None if self.qdtype is None
                  else torch.zeros((0, self.dim), dtype=self.qdtype))
        return ShadowedTable(master=m[:self.vocab], shadow=shadow,
                             accum=a[:self.vocab])

    def flush(self) -> None:
        """Write every dirty chunk's window rows back to the host store and
        clear the dirty flags (end-of-run extraction of the master)."""
        with self._lock:
            self._await_drains_locked()
            for save in self._saves:
                save.preserve(np.flatnonzero(self.dirty))
            self._flush_into_locked(self.host_master, self.host_accum)
            self.dirty[:] = False
            self.dirty_rows.clear()
            self._landed.clear()

    def _check_lost_locked(self) -> None:
        if self._lost:
            raise RuntimeError(f"the writeback of chunks "
                               f"{sorted(self._lost)} failed: their rows "
                               f"are lost until adopt()")

    def _flush_into_locked(self, m: np.ndarray, a: np.ndarray):
        self._check_lost_locked()
        win = self._window
        d = np.flatnonzero(self.dirty)
        if d.size and win is None:
            raise RuntimeError("dirty chunks but no window to flush from")
        m3 = m.reshape(-1, self.chunk_rows, self.dim)
        a3 = a.reshape(-1, self.chunk_rows, self.dim)
        for lo in range(0, d.size, CHUNKS_PER_COPY):
            c = d[lo:lo + CHUNKS_PER_COPY]
            m3[c] = self._read_chunks(win.master, self.chunk_slot[c])
            a3[c] = self._read_chunks(win.accum, self.chunk_slot[c])
        return m, a

    def table_snapshot(self):
        """The full ``(V, D)`` master and accumulator as they are now, as
        two leaves a checkpoint streams from the host store (``pieces()``,
        ``shape``, ``dtype``, ``nbytes``, ``close()``), without a copy of
        the table: the window's dirty chunks are copied to the host here
        (on the caller's stream, after its enqueued work), and until both
        leaves are closed a writeback copies the old store rows of a chunk
        a leaf has not read yet aside first. Each leaf is read once; a save
        closes them."""
        with self._lock:
            self._await_drains_locked()
            self._check_lost_locked()
            d = np.flatnonzero(self.dirty)
            overlay = {}
            for lo in range(0, d.size, CHUNKS_PER_COPY):
                c = d[lo:lo + CHUNKS_PER_COPY]
                m = self._read_chunks(self._window.master, self.chunk_slot[c])
                a = self._read_chunks(self._window.accum, self.chunk_slot[c])
                for j, chunk in enumerate(c.tolist()):
                    overlay[chunk] = (m[j], a[j])
            save = _TableSave(self, overlay)
            self._saves.add(save)
        return _StoreLeaf(save, 0), _StoreLeaf(save, 1)

    def _end_save(self, save: _TableSave) -> None:
        with self._lock:
            self._saves.discard(save)
            self.stats.cow_chunks += save.copied_aside
            self._drained.notify_all()

    def adopt(self, table, pending_ids=None
              ) -> Tuple[ShadowedTable, np.ndarray]:
        """Load a full ``(V, D)`` table (``.master``/``.accum`` numpy or
        tensors; a restored checkpoint) into the host store and rebuild
        residency from the accumulated frequency counters; chunks of live
        ``pending_ids`` (global, −1 = empty) are force-admitted and pinned
        as the τ=1 pending carry. Refills the window in place (on the
        caller's stream) and returns ``(window, slot_pending_ids)``."""
        p = (np.asarray(pending_ids, np.int64).reshape(-1)
             if pending_ids is not None else np.empty(0, np.int64))
        live = np.unique(np.clip(p[p >= 0], 0, self.vocab - 1))
        forced = np.unique(live // self.chunk_rows)
        if forced.size > self.capacity_chunks:
            raise CacheThrash(f"{forced.size} pending-pair chunks exceed "
                              f"capacity {self.capacity_chunks}")
        with self._lock:
            self._await_drains_locked()
            while self._saves:              # a save still reads the store
                self._drained.wait()
            self._lost.clear()
            for dst, src in ((self.host_master, table.master),
                             (self.host_accum, table.accum)):
                _copy_rows_to_host(dst, src)
                dst[self.vocab:] = 0.0
            self.dirty[:] = False
            self.dirty_rows.clear()
            self._landed.clear()
            self._loading.clear()
            self.pins[:] = 0
            self._batch_chunks.clear()
            self._batch_rows.clear()
            self._pending_chunks = None
            self._pending_rows = None
            # admission: forced pending chunks + hottest fill
            admit = list(forced)
            taken = set(admit)
            for c in np.argsort(-self.freq, kind="stable"):
                if len(admit) >= min(self.capacity_chunks, self.num_chunks):
                    break
                if int(c) not in taken:
                    admit.append(int(c))
                    taken.add(int(c))
            admit = np.sort(np.asarray(admit, np.int64))
            self.chunk_slot[:] = -1
            self.slot_chunk[:] = -1
            self.chunk_slot[admit] = np.arange(admit.size)
            self.slot_chunk[:admit.size] = admit
        win = self.init_window()
        with self._lock:
            if forced.size:
                self.pins[forced] += 1
                self._pending_chunks = forced
                self._pending_rows = self.chunk_candidates([live])[2]
        return win, (self.slotize_pending(p) if pending_ids is not None
                     else np.empty(0, np.int32))

    # -- introspection ------------------------------------------------------
    def resident_chunks(self) -> np.ndarray:
        with self._lock:
            return np.flatnonzero(self.chunk_slot >= 0)

    def counters(self) -> Dict[str, float]:
        """Flat snapshot of the cumulative stats (benchmark/JSON form)."""
        s = self.stats
        return {"hits": s.hits, "misses": s.misses,
                "hit_rate": s.hit_rate, "evictions": s.evictions,
                "writebacks": s.writebacks,
                "swap_in_bytes": s.swap_in_bytes,
                "swap_out_bytes": s.swap_out_bytes,
                "warmup_bytes": s.warmup_bytes,
                "writeback_rows_dirty": s.writeback_rows_dirty,
                "writeback_rows_total": s.writeback_rows_total}
