"""Request scheduler — the admission layer of the recall-serving engine.

Per-user history requests arrive one at a time (``submit``); the scheduler
packs them into capacity-bounded jagged micro-batches shaped exactly like
the training loader's per-device packs — (G, cap) token buffers with
per-shard offsets — so the serving forward reuses the training stack
unchanged (one ``build_attn_plan`` per micro-batch, shared by all layers).

Packing reuses the §4.1.3 load-balance primitives: requests are spread
over the G serving shards by LPT greedy (``core.load_balance.
global_token_reallocation``), so per-shard token loads stay balanced on
long-tail histories — the serving-side twin of the training-time
straggler mitigation. Shard overflow (more than ``users_per_shard`` rows
or ``capacity`` tokens after LPT) spills to the next micro-batch rather
than being dropped.

Flush policy: a batch is ``ready`` when either the pending count reaches
one full micro-batch (G · users_per_shard) or the oldest pending request
has waited ``max_delay_ms`` — the standard deadline/max-batch tradeoff.
All timestamps can be injected (``now=``) so tests and benchmarks are
deterministic.

Every request gets a monotone ``rid`` and a latency record
(enqueue/dispatch/done, cache-hit flag); :meth:`latency_stats` reduces
them to p50/p99/mean.

:class:`ContinuousScheduler` is the continuous-batching engine's admission
layer: open-loop admission with typed outcomes (:class:`Admission`) and
FIFO tick formation under row and token budgets (:class:`TickPlan`). This
module is numpy only: a copy of the JAX package's schedulers.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import load_balance as LB


def _now() -> float:
    return time.monotonic()


@dataclass
class ServeRequest:
    rid: int
    user: int
    ids: np.ndarray          # (n,) truncated chronological history
    timestamps: np.ndarray   # (n,) matching timestamps
    t_enqueue: float

    @property
    def n(self) -> int:
        return int(len(self.ids))


@dataclass(frozen=True)
class Slot:
    """request → position mapping inside a packed micro-batch."""
    rid: int
    user: int
    shard: int               # g index into the (G, cap) buffers
    row: int                 # sequence index within the shard
    lo: int                  # token range [lo, hi) within the shard buffer
    hi: int


@dataclass
class MicroBatch:
    """One jagged pack, model-ready: the same layout GRLoader emits."""
    ids: np.ndarray          # (G, cap) int32
    timestamps: np.ndarray   # (G, cap) int32, per-request relative
    offsets: np.ndarray      # (G, S+1) int32, pad rows repeat the total
    last_pos: np.ndarray     # (G, S) int32 last-token slot per row
    slots: List[Slot]

    @property
    def num_requests(self) -> int:
        return len(self.slots)

    @property
    def num_tokens(self) -> int:
        return int(self.offsets[:, -1].sum())


class RequestScheduler:
    """Deadline/size-triggered jagged micro-batcher over G serving shards."""

    def __init__(self, num_shards: int, users_per_shard: int,
                 max_seq_len: int, *, tokens_per_shard: Optional[int] = None,
                 max_delay_ms: float = 10.0, max_records: int = 100_000):
        if num_shards < 1 or users_per_shard < 1 or max_seq_len < 1:
            raise ValueError((num_shards, users_per_shard, max_seq_len))
        self.num_shards = num_shards
        self.users_per_shard = users_per_shard
        self.max_seq_len = max_seq_len
        # token capacity per shard = the packed buffer width. The default
        # (users_per_shard · max_seq_len) is the padded worst case, where
        # only the row cap can bind; real long-tail traffic packs far
        # tighter, so pass tokens_per_shard ≈ users_per_shard · mean_len
        # to shrink the (G, cap) buffers — then the token bound bites and
        # over-long packs spill to the next micro-batch.
        cap = (users_per_shard * max_seq_len if tokens_per_shard is None
               else min(tokens_per_shard, users_per_shard * max_seq_len))
        if cap < max_seq_len:
            raise ValueError(
                f"tokens_per_shard={cap} cannot hold one max-length "
                f"sequence ({max_seq_len})")
        self.capacity = cap
        self.max_delay_s = max_delay_ms / 1e3
        self.max_records = max_records
        self._pending: List[ServeRequest] = []
        self._next_rid = 0
        self.records: Dict[int, Dict[str, float]] = {}

    # -- admission ---------------------------------------------------------
    def _new_record(self, user: int, now: float, hit: bool) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.records[rid] = {"user": user, "t_enqueue": now,
                             "t_dispatch": np.nan, "t_done": np.nan,
                             "hit": hit}
        # rolling window: a long-running engine must not grow latency
        # state with all-time traffic — evict the oldest *completed*
        # records past the bound (in-flight ones are kept; insertion
        # order == rid order, so this drops the oldest finished first)
        if len(self.records) > self.max_records:
            # drop to 90% in one pass so the scan amortizes to O(1)/request
            excess = len(self.records) - (self.max_records * 9) // 10
            drop = [r for r, rec in self.records.items()
                    if np.isfinite(rec["t_done"])][:excess]
            for r in drop:
                del self.records[r]
        return rid

    def submit(self, user: int, ids: Sequence[int], timestamps: Sequence[int],
               *, now: Optional[float] = None) -> int:
        """Enqueue one history for encoding; returns the request id."""
        now = _now() if now is None else now
        ids = np.asarray(ids, np.int32)
        ts = np.asarray(timestamps, np.int32)
        if ids.size == 0 or ids.size != ts.size:
            raise ValueError(f"bad history: {ids.size} ids, {ts.size} ts")
        ids = ids[-self.max_seq_len:]
        ts = ts[-self.max_seq_len:]
        rid = self._new_record(user, now, hit=False)
        self._pending.append(ServeRequest(rid, user, ids, ts, now))
        return rid

    def record_hit(self, user: int, *, now: Optional[float] = None) -> int:
        """Latency record for a request served from the state cache (it
        never enters the packing queue)."""
        now = _now() if now is None else now
        rid = self._new_record(user, now, hit=True)
        self.records[rid]["t_dispatch"] = now
        return rid

    # -- flush policy ------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._pending)

    def ready(self, now: Optional[float] = None) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.num_shards * self.users_per_shard:
            return True
        now = _now() if now is None else now
        return now - self._pending[0].t_enqueue >= self.max_delay_s

    # -- packing -----------------------------------------------------------
    def flush(self, now: Optional[float] = None) -> List[MicroBatch]:
        """Drain the queue into capacity-bounded micro-batches.

        Invariants (tests/test_torch_serving.py): per shard, row count ≤
        users_per_shard and token count ≤ capacity; every pending rid lands
        in exactly one slot; slot (shard, lo, hi) reproduces the request's
        ids verbatim.
        """
        now = _now() if now is None else now
        G, S = self.num_shards, self.users_per_shard
        out: List[MicroBatch] = []
        # deque drain: chunks pop off the front, spills push back to the
        # front in arrival order — O(1) per move, so a large burst drains
        # in O(P · G·S) host work instead of rebuilding the whole pending
        # list every micro-batch
        queue = deque(self._pending)
        self._pending = []
        while queue:
            chunk = [queue.popleft()
                     for _ in range(min(len(queue), G * S))]
            lengths = [r.n for r in chunk]
            assign = LB.global_token_reallocation(lengths, G)
            shard_rows: List[List[int]] = []
            spill: List[int] = []
            for rows in assign:
                kept, tokens = [], 0
                for ri in rows:
                    if (len(kept) < S
                            and tokens + lengths[ri] <= self.capacity):
                        kept.append(ri)
                        tokens += lengths[ri]
                    else:
                        spill.append(ri)
                shard_rows.append(kept)
            out.append(self._pack(chunk, shard_rows, now))
            for ri in sorted(spill, reverse=True):
                queue.appendleft(chunk[ri])
        return out

    def _pack(self, chunk: List[ServeRequest],
              shard_rows: List[List[int]], now: float) -> MicroBatch:
        G, S, cap = self.num_shards, self.users_per_shard, self.capacity
        ids = np.zeros((G, cap), np.int32)
        ts = np.zeros((G, cap), np.int32)
        offsets = np.zeros((G, S + 1), np.int32)
        last_pos = np.zeros((G, S), np.int32)
        slots: List[Slot] = []
        for g, rows in enumerate(shard_rows):
            cur = 0
            for j, ri in enumerate(rows):
                r = chunk[ri]
                n = r.n
                ids[g, cur:cur + n] = r.ids
                ts[g, cur:cur + n] = r.timestamps - r.timestamps[0]
                slots.append(Slot(r.rid, r.user, g, j, cur, cur + n))
                cur += n
                offsets[g, j + 1] = cur
                last_pos[g, j] = cur - 1
                self.records[r.rid]["t_dispatch"] = now
            offsets[g, len(rows) + 1:] = cur
        return MicroBatch(ids=ids, timestamps=ts, offsets=offsets,
                          last_pos=last_pos, slots=slots)

    # -- accounting --------------------------------------------------------
    def mark_done(self, rids: Sequence[int],
                  now: Optional[float] = None) -> None:
        now = _now() if now is None else now
        for rid in rids:
            self.records[rid]["t_done"] = now

    def latency_stats(self, now: Optional[float] = None) -> Dict[str, float]:
        """p50/p99/mean end-to-end latency + queue delay over completed
        requests (seconds), plus the two honesty fields that keep tail
        numbers meaningful under overload — completed-only percentiles
        flatter p99 when requests are stuck in the queue, so ``queue_depth``
        (admitted but unfinished) and ``oldest_inflight_age_s`` are always
        reported alongside. The key set is stable — with no completed
        requests yet, latencies are NaN (so monitoring callers can index
        unconditionally)."""
        now = _now() if now is None else now
        done = [r for r in self.records.values()
                if np.isfinite(r["t_done"])]
        if not done:
            nan = float("nan")
            out = {"count": 0, "p50_s": nan, "p99_s": nan, "mean_s": nan,
                   "queue_p50_s": nan, "cache_hits": 0,
                   "cache_hit_rate": 0.0}
        else:
            lat = np.array([r["t_done"] - r["t_enqueue"] for r in done])
            queue = np.array([r["t_dispatch"] - r["t_enqueue"] for r in done])
            hits = sum(1 for r in done if r["hit"])
            out = {
                "count": len(done),
                "p50_s": float(np.percentile(lat, 50)),
                "p99_s": float(np.percentile(lat, 99)),
                "mean_s": float(lat.mean()),
                "queue_p50_s": float(np.percentile(queue, 50)),
                "cache_hits": hits,
                "cache_hit_rate": hits / len(done),
            }
        out.update(_inflight_stats(self.records, now))
        return out


def _inflight_stats(records: Dict[int, Dict[str, float]],
                    now: float) -> Dict[str, float]:
    """Overload honesty: how much admitted work has NOT completed, and how
    stale its oldest member is. A benchmark whose p99 looks bounded while
    ``oldest_inflight_age_s`` grows without bound is over capacity."""
    ages = [now - r["t_enqueue"] for r in records.values()
            if not np.isfinite(r["t_done"])]
    return {"queue_depth": len(ages),
            "oldest_inflight_age_s": max(ages) if ages else 0.0}


# --------------------------------------------------------------------------
# continuous scheduler — open-loop admission for the slot-buffer engine
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Admission:
    """Typed outcome of ``StreamingRecallEngine.submit``.

    ``accepted``   — admitted; the result arrives from a later ``tick``.
    ``shed_queue`` — admission control: in-flight work at ``queue_limit``.
    ``shed_slots`` — no slot free and nothing evictable (or eviction off).
    ``resend_full``— the user was evicted since last seen; this delta was
                     dropped and the client must resend the full history
                     (reported exactly once per eviction, like the PR-4
                     engine's KeyError handshake, but as data not control
                     flow).
    """
    rid: Optional[int]
    outcome: str
    user: int
    hit: bool = False

    @property
    def accepted(self) -> bool:
        return self.rid is not None


@dataclass
class TickPlan:
    """One engine tick's worth of pending work, budget-bounded."""
    warm: List[Tuple[int, List[int]]]       # (slot, waiting rids)
    cold: List[Tuple[int, List[int]]]
    rank_only: List[Tuple[int, List[int]]]  # fresh emb, stale top-k
    rows: int = 0
    tokens: int = 0

    @property
    def empty(self) -> bool:
        return not (self.warm or self.cold or self.rank_only)


class ContinuousScheduler:
    """Open-loop admission + tick formation for the continuous engine.

    Requests are admitted one at a time into slot-attached work queues and
    each ``form_tick`` drains pending *slots* FIFO under two budgets: at
    most ``max_rows_per_tick`` encode rows and ``max_tokens_per_tick``
    encode tokens per tick (a cold slot costs its full live length, a warm
    slot only its appended events). Admission control is a hard bound on
    in-flight work (``queue_limit``) — beyond it ``has_capacity`` turns
    False and the engine sheds instead of queueing, trading throughput for
    a bounded tail.

    The FIFO stops at the first slot that does not fit the remaining
    budget (no skip-ahead), so a long cold row cannot be starved by a
    stream of cheap warm appends.
    """

    def __init__(self, *, max_rows_per_tick: int = 32,
                 max_tokens_per_tick: Optional[int] = None,
                 queue_limit: int = 1024, max_records: int = 100_000):
        if max_rows_per_tick < 1 or queue_limit < 1:
            raise ValueError((max_rows_per_tick, queue_limit))
        self.max_rows = max_rows_per_tick
        self.max_tokens = max_tokens_per_tick
        self.queue_limit = queue_limit
        self.max_records = max_records
        self._next_rid = 0
        self.records: Dict[int, Dict[str, float]] = {}
        self.inflight = 0
        self._queue: deque = deque()            # slots FIFO, deduped
        self._queued: set = set()
        self._waiting: Dict[int, List[int]] = {}
        self._rank_only: Dict[int, List[int]] = {}
        self.outcomes: Dict[str, int] = {
            "accepted": 0, "shed_queue": 0, "shed_slots": 0,
            "resend_full": 0}
        # occupancy accounting over non-empty ticks
        self.ticks = 0
        self._row_used = 0
        self._token_used = 0

    # -- admission ---------------------------------------------------------

    def has_capacity(self) -> bool:
        return self.inflight < self.queue_limit

    def shed(self, outcome: str) -> None:
        self.outcomes[outcome] += 1

    def admit(self, user: int, now: float, *, hit: bool = False) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.records[rid] = {"user": user, "t_enqueue": now,
                             "t_dispatch": np.nan, "t_done": np.nan,
                             "hit": hit}
        if len(self.records) > self.max_records:
            excess = len(self.records) - (self.max_records * 9) // 10
            drop = [r for r, rec in self.records.items()
                    if np.isfinite(rec["t_done"])][:excess]
            for r in drop:
                del self.records[r]
        self.inflight += 1
        self.outcomes["accepted"] += 1
        return rid

    def enqueue(self, slot: int, rid: int) -> None:
        """Attach a request to its slot's encode work."""
        self._waiting.setdefault(slot, []).append(rid)
        if slot not in self._queued:
            self._queued.add(slot)
            self._queue.append(slot)

    def enqueue_rank(self, slot: int, rid: int) -> None:
        """Fresh embedding, stale top-k: retrieval-only work."""
        self._rank_only.setdefault(slot, []).append(rid)

    def drop_slot(self, slot: int) -> List[int]:
        """Remove a slot's pending work (its user was evicted mid-queue);
        returns the orphaned rids for the engine to fail/complete."""
        if slot in self._queued:
            self._queued.discard(slot)
            self._queue.remove(slot)
        rids = self._waiting.pop(slot, []) + self._rank_only.pop(slot, [])
        return rids

    @property
    def queued_slots(self) -> int:
        return len(self._queue)

    def busy_slots(self) -> set:
        """Slots with attached pending work — the engine must not LRU-evict
        these (their waiting rids would be orphaned mid-flight)."""
        return set(self._waiting) | set(self._rank_only)

    # -- tick formation ----------------------------------------------------

    def form_tick(self, now: float, cost_of) -> TickPlan:
        """Drain pending slots FIFO under the row/token budgets.

        ``cost_of(slot) -> (kind, tokens)`` with kind "warm" | "cold" is
        evaluated at tick time (appends between admission and tick change a
        slot's cost — the latest state wins, and coalesced same-user
        requests are all answered by the one encode)."""
        plan = TickPlan(warm=[], cold=[], rank_only=[])
        budget = (self.max_tokens if self.max_tokens is not None
                  else self.max_rows * (1 << 62))
        while self._queue:
            slot = self._queue[0]
            kind, cost = cost_of(slot)
            if plan.rows + 1 > self.max_rows:
                break
            # the token budget never blocks the first slot of a tick — a
            # single over-budget row must still be servable, else the
            # queue would deadlock
            if plan.rows > 0 and plan.tokens + cost > budget:
                break
            self._queue.popleft()
            self._queued.discard(slot)
            rids = self._waiting.pop(slot, [])
            for rid in rids:
                self.records[rid]["t_dispatch"] = now
            (plan.warm if kind == "warm" else plan.cold).append((slot, rids))
            plan.rows += 1
            plan.tokens += cost
        for slot, rids in self._rank_only.items():
            for rid in rids:
                self.records[rid]["t_dispatch"] = now
            plan.rank_only.append((slot, rids))
        self._rank_only.clear()
        if not plan.empty:
            self.ticks += 1
            self._row_used += plan.rows
            self._token_used += plan.tokens
        return plan

    # -- accounting --------------------------------------------------------

    def mark_done(self, rids: Sequence[int],
                  now: Optional[float] = None) -> None:
        now = _now() if now is None else now
        for rid in rids:
            rec = self.records.get(rid)
            if rec is not None and not np.isfinite(rec["t_done"]):
                rec["t_done"] = now
                self.inflight -= 1

    def occupancy(self) -> Dict[str, float]:
        t = max(self.ticks, 1)
        out = {"ticks": self.ticks,
               "mean_rows_per_tick": self._row_used / t,
               "row_utilization": self._row_used / (t * self.max_rows)}
        if self.max_tokens:
            out["token_utilization"] = self._token_used / (t * self.max_tokens)
        return out

    def latency_stats(self, now: Optional[float] = None) -> Dict[str, float]:
        """Same honest shape as :meth:`RequestScheduler.latency_stats`."""
        now = _now() if now is None else now
        done = [r for r in self.records.values()
                if np.isfinite(r["t_done"])]
        if not done:
            nan = float("nan")
            out = {"count": 0, "p50_s": nan, "p99_s": nan, "mean_s": nan,
                   "queue_p50_s": nan, "cache_hits": 0,
                   "cache_hit_rate": 0.0}
        else:
            lat = np.array([r["t_done"] - r["t_enqueue"] for r in done])
            queue = np.array([r["t_dispatch"] - r["t_enqueue"] for r in done])
            hits = sum(1 for r in done if r["hit"])
            out = {
                "count": len(done),
                "p50_s": float(np.percentile(lat, 50)),
                "p99_s": float(np.percentile(lat, 99)),
                "mean_s": float(lat.mean()),
                "queue_p50_s": float(np.percentile(queue, 50)),
                "cache_hits": hits,
                "cache_hit_rate": hits / len(done),
            }
        out.update(_inflight_stats(self.records, now))
        return out
