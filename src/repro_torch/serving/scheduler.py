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
them to p50/p99/mean. This module is numpy only: a copy of the JAX
package's request scheduler (the continuous scheduler comes later).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

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
