"""Recall-serving engines: scheduler → cached jagged encode → sharded
quantized top-k (:class:`RecallEngine`), and continuous batching over
device-resident user state (:class:`StreamingRecallEngine`).

One :class:`RecallEngine` owns the serving path for a trained GR model:

  1. ``submit`` merges a request's new events into the user-state cache.
     An unchanged user with a version-current embedding is a cache hit and
     skips packing and encoding. Changed or new users enqueue their
     (ring-buffer-truncated) history with the request scheduler.
  2. ``step`` flushes the scheduler into capacity-bounded jagged
     micro-batches (LPT over the G serving packs) and runs the serving
     forward, embedding lookup + ``gr_user_embeddings_sharded``, once per
     micro-batch on the engine's device. The attention plan is built once
     per micro-batch and shared by every layer; on the card each layer is
     one launch of the jagged attention kernel over all G packs.
  3. Requests that need a ranking are scored together by the blocked top-k
     scan over the FP16 shadow table; hits whose top-k is version-current
     skip even that. Results come back in submission order.

:class:`StreamingRecallEngine` keeps user sequences on the device in slot
rows and moves only deltas: open-loop typed admission, budget-bounded
ticks, cold encodes that fill per-layer K/V caches, warm encodes of only
the appended events against them (HSTU), and ranking straight from the
device embedding buffer.

``user_emb`` in a result is an fp32 numpy array holding the model dtype's
values (numpy has no bfloat16).

Both engines take ``obs`` (a :class:`repro_torch.obs.Obs`): spans named as
the reference's (``encode``/``retrieval`` for :class:`RecallEngine`;
``tick``, ``encode_cold``, ``encode_warm`` and ``rank`` for the streaming
engine), and ``stats()`` mirrored into the registry under ``serve_``. A
disabled or absent ``obs`` changes no result and no stat; a span is the
host's time and adds no synchronisation.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.embedding import tables as ET
from repro_torch.models import gr as GR
from repro_torch.obs import NULL_SPAN, Obs
from repro_torch.serving import retrieval as RT
from repro_torch.serving.retrieval import ShardedTopK
from repro_torch.serving.scheduler import (Admission, ContinuousScheduler,
                                           RequestScheduler)
from repro_torch.serving.slot_buffer import (BucketLadder, CompileCache,
                                             SequenceBuffer)
from repro_torch.serving.state_cache import UserStateCache


@dataclass
class ServeResult:
    rid: int
    user: int
    item_ids: np.ndarray      # (k,) int32, score-descending
    scores: np.ndarray        # (k,) fp32
    user_emb: np.ndarray      # (d,) the representation that was ranked
    cache_hit: bool


def _null_span(*args: Any, **kwargs: Any):
    return NULL_SPAN


def _obs_hooks(obs: Optional[Obs]):
    """(span_fn, registry) for an engine: both no-ops when obs is absent
    or disabled."""
    if obs is not None and obs.enabled:
        return obs.tracer.span, obs.metrics
    return _null_span, None


def _bucket(n: int) -> int:
    """Next power-of-two ≥ n: retrieval batches come in log₂ sizes."""
    b = 1
    while b < n:
        b <<= 1
    return b


def _serving_table(model: GR.GRModel, table: Any, use_shadow: bool,
                   device: torch.device) -> ET.ShadowedTable:
    """The engine's table: a ShadowedTable as given, or one built from a
    raw master (no (V, D) fp32 AdaGrad accumulator, and the fp16 shadow
    only if retrieval will scan it); model and table must lie on the
    engine's device."""
    if not isinstance(table, ET.ShadowedTable):
        table = ET.ShadowedTable(
            master=table,
            shadow=table.to(torch.float16) if use_shadow else None,
            accum=torch.zeros((0, table.shape[-1]), dtype=torch.float32,
                              device=table.device))
    for name, t in (("model", next(model.parameters())),
                    ("table", table.master)):
        if t.device.type != device.type:
            raise ValueError(f"{name} lies on {t.device}, the engine "
                             f"runs on {device}")
    return table


class RecallEngine:
    """Serving engine over a trained (GRModel, ShadowedTable) pair, on
    ``device`` (``None`` means the card; without a card it raises)."""

    def __init__(self, cfg: ArchConfig, model: GR.GRModel, table: Any, *,
                 num_shards: int = 1, users_per_shard: int = 8,
                 tokens_per_shard: Optional[int] = None,
                 k: int = 100, retrieval_block: int = 4096,
                 use_shadow: bool = True, max_delay_ms: float = 10.0,
                 attn_fn: Optional[Callable] = None,
                 cache_users: Optional[int] = None,
                 device: DeviceLike = None, obs: Optional[Obs] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.obs = obs
        self._span, self._mx = _obs_hooks(obs)
        self.table = _serving_table(model, table, use_shadow, self.device)
        self.k = k
        self.num_shards = num_shards
        self.users_per_shard = users_per_shard
        self.scheduler = RequestScheduler(
            num_shards, users_per_shard, cfg.max_seq_len,
            tokens_per_shard=tokens_per_shard, max_delay_ms=max_delay_ms)
        self.cache = UserStateCache(cfg.max_seq_len, max_users=cache_users)
        self.retriever = ShardedTopK(
            k, block_v=min(retrieval_block, self.table.master.shape[0]),
            use_shadow=use_shadow)
        # (rid, user, embedding, cached top-k or None, version), snapshotted
        # at submit time so a later eviction or same-user append between
        # submit and step cannot corrupt a recorded hit
        self._hits: List[Tuple[int, int, np.ndarray,
                               Optional[Tuple[np.ndarray, np.ndarray]],
                               int]] = []
        # rid → history version the request's encode was snapshotted at
        self._snap_version: Dict[int, int] = {}
        self.encoded_batches = 0
        self.retrieval_batches = 0
        self.attn_fn = attn_fn or GR.default_attn_fn(cfg)
        self._dtype = GR.torch_dtype(cfg.dtype)
        #: host seconds of the last step's phases (after a device sync)
        self.last_step_s: Dict[str, float] = {}

    @torch.no_grad()
    def _encode(self, mb) -> np.ndarray:
        dev = self.device
        ids = torch.from_numpy(mb.ids).to(dev)
        x = ET.lookup(self.table.master, ids, dtype=self._dtype)
        emb = GR.gr_user_embeddings_sharded(
            self.model, self.cfg, x, torch.from_numpy(mb.offsets).to(dev),
            torch.from_numpy(mb.timestamps).to(dev),
            torch.from_numpy(mb.last_pos).to(dev), attn_fn=self.attn_fn)
        return emb.float().cpu().numpy()

    # -- request side ------------------------------------------------------
    def submit(self, user: int, new_ids: Sequence[int] = (),
               new_ts: Sequence[int] = (), *,
               now: Optional[float] = None) -> int:
        """Merge new events for ``user`` and enqueue if re-encoding is
        needed; returns the request id. Raises KeyError for a user whose
        cached state was evicted (a delta cannot rebuild the history)."""
        if self.cache.get(user) is None:
            if self.cache.take_evicted(user):
                raise KeyError(
                    f"user {user}: cached state was evicted — resend the "
                    f"full history")
            if np.asarray(new_ids).size == 0:
                raise ValueError(f"user {user}: request with no history")
        st, needs_encode = self.cache.update(user, new_ids, new_ts)
        if not needs_encode:
            rid = self.scheduler.record_hit(user, now=now)
            self._hits.append((rid, user, st.fresh_embedding(),
                               st.fresh_topk(), st.version))
            return rid
        ids, ts = st.history()
        if ids.size == 0:
            raise ValueError(f"user {user}: request with no history")
        rid = self.scheduler.submit(user, ids, ts, now=now)
        self._snap_version[rid] = st.version
        return rid

    # -- serving step ------------------------------------------------------
    def step(self, *, force: bool = False,
             now: Optional[float] = None) -> List[ServeResult]:
        """Encode + rank everything currently servable; results in
        submission (rid) order. Cache hits never wait on the batching
        policy."""
        run_flush = force or self.scheduler.ready(now)
        if not (run_flush or self._hits):
            return []
        self.last_step_s = {}
        pending: List[Tuple[int, int, bool, np.ndarray, Optional[int]]] = []
        results: List[ServeResult] = []
        if run_flush:
            t0 = time.perf_counter()
            mbs = self.scheduler.flush(now)
            with self._span("encode", "serve_encode", batches=len(mbs)):
                for mb in mbs:
                    out = self._encode(mb)
                    self.encoded_batches += 1
                    for s in mb.slots:
                        e = out[s.shard, s.row].copy()
                        ver = self._snap_version.pop(s.rid, None)
                        self.cache.store(s.user, e, ver)
                        pending.append((s.rid, s.user, False, e, ver))
            self.last_step_s["encode"] = time.perf_counter() - t0
        for rid, user, emb, topk, ver in self._hits:
            if topk is not None:
                results.append(ServeResult(rid=rid, user=user,
                                           item_ids=topk[0].copy(),
                                           scores=topk[1].copy(),
                                           user_emb=emb.copy(),
                                           cache_hit=True))
            else:
                pending.append((rid, user, True, emb, ver))
        self._hits = []
        if not (pending or results):
            return []

        if pending:
            t0 = time.perf_counter()
            B = len(pending)
            with self._span("retrieval", "serve_rank", batch=B):
                d = pending[0][3].shape[-1]
                E = np.zeros((_bucket(B), d), np.float32)
                E[:B] = np.stack([p[3] for p in pending]).astype(np.float32)
                vals, idx = self.retriever(
                    self.table, torch.from_numpy(E).to(self.device))
                self.retrieval_batches += 1
                vals = vals[:B].cpu().numpy()
                idx = idx[:B].cpu().numpy()
            self.last_step_s["retrieval"] = time.perf_counter() - t0
            for i, (rid, user, hit, emb, ver) in enumerate(pending):
                self.cache.store_topk(user, idx[i], vals[i], ver)
                results.append(ServeResult(rid=rid, user=user,
                                           item_ids=idx[i], scores=vals[i],
                                           user_emb=emb.copy(),
                                           cache_hit=hit))

        done = time.monotonic() if now is None else now
        self.scheduler.mark_done([r.rid for r in results], now=done)
        results.sort(key=lambda r: r.rid)
        return results

    def serve(self, requests: Sequence[Tuple[int, Sequence[int],
                                             Sequence[int]]], *,
              now: Optional[float] = None) -> List[ServeResult]:
        """Submit ``(user, new_ids, new_ts)`` triples, force one step,
        return results in request order. Every request is validated before
        any is enqueued, so a rejected batch strands nothing."""
        evicted: List[int] = []
        seeded: set = set()
        for user, ids, ts in requests:
            n_ids = np.asarray(ids, np.int32).size
            n_ts = np.asarray(ts, np.int32).size
            if n_ids != n_ts:
                raise ValueError(f"user {user}: event delta mismatch: "
                                 f"{n_ids} ids, {n_ts} ts")
            if self.cache.get(user) is None and user not in seeded:
                if self.cache.is_evicted(user):
                    evicted.append(user)
                elif n_ids == 0:
                    raise ValueError(
                        f"user {user}: request with no history")
            if n_ids or self.cache.get(user) is not None:
                seeded.add(user)
        if evicted:
            for u in evicted:
                self.cache.take_evicted(u)
            raise KeyError(f"users {evicted}: cached state was evicted — "
                           f"resend the full histories")
        # pin the batch against LRU eviction by its own new members
        with self.cache.pinned(u for u, _, _ in requests):
            for user, ids, ts in requests:
                self.submit(user, ids, ts, now=now)
            return self.step(force=True, now=now)

    # -- accounting --------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        out = {"latency": self.scheduler.latency_stats(),
               "cache": self.cache.stats(),
               "encoded_batches": self.encoded_batches,
               "retrieval_table_dtype":
                   str(self.retriever.scan_table(self.table).dtype)}
        if self._mx is not None:
            # mirrored into the registry; the dict is returned unchanged
            self._mx.publish("serve", out)
        return out


# --------------------------------------------------------------------------
# continuous-batching engine
# --------------------------------------------------------------------------

class _RankGraph:
    """The rank step for one row bucket, captured once as a CUDA graph:
    ``rows`` is copied into the graph's own input and the graph replayed.
    The replay runs the kernels the eager step runs, on the same shapes, so
    its result is the eager one bit for bit. The outputs are the graph's
    own tensors, overwritten by the next replay."""

    def __init__(self, step: Callable, rows: torch.Tensor):
        self.rows = rows.clone()
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)
        # one eager run first, for the lazy set-up the capture may not do,
        # on the stream the capture will use: every graph shares it, so
        # cuBLAS keeps one workspace for them (it keeps one per stream)
        side = capture.capture_stream
        side.wait_stream(torch.cuda.current_stream(rows.device))
        with torch.cuda.stream(side):
            step(self.rows)
        with capture:
            self.out = step(self.rows)

    def __call__(self, rows: torch.Tensor):
        self.rows.copy_(rows)
        self.graph.replay()
        return self.out


class StreamingRecallEngine:
    """Continuous-batching serving over a persistent device-resident
    :class:`SequenceBuffer`, on ``device`` (``None`` means the card;
    without a card it raises).

    Where :class:`RecallEngine` re-packs every changed user's full history
    into transient jagged micro-batches, this engine keeps user sequences
    on the device in slot rows and moves only deltas:

      * ``submit`` is open-loop admission: it never blocks and returns a
        typed :class:`Admission` (accepted / shed_queue / shed_slots /
        resend_full) instead of raising on overload. New events merge into
        the user's slot; the encode work is attached to the slot, so a
        burst of same-user requests coalesces into one encode.
      * ``tick`` forms one budget-bounded batch
        (``ContinuousScheduler.form_tick``), runs the cold path (a full
        encode of seeded or truncated slots, R rows as R one-row packs, one
        K1-fwd launch per layer, filling the K/V caches) and the warm path
        (``gr_append_slots``: only the appended window against the cached
        prefix, one append launch of K1-fwd per layer, bit for bit the
        cold encode of the grown row), then ranks every finished slot
        straight from the device embedding buffer
        (``retrieval.topk_from_slots``).

    Prefix reuse holds for HSTU only (its block's K/V are the cache); FuXi
    and SASRec serve cold-only through ``gr_encode_slots_flat``. Every step
    runs at shapes from a shared :class:`BucketLadder` and is counted by a
    :class:`CompileCache`; on the card the rank step is captured as one
    CUDA graph per row bucket, whose replay replaces the eager loop over
    vocab blocks by one launch.

    Against :class:`RecallEngine` on the same trace the results agree to
    the kernels' rounding, not bit for bit: RecallEngine packs users at
    arbitrary offsets of a shared pack, so K1-fwd tiles their keys in
    other 128-key blocks and sums them in another order.
    """

    def __init__(self, cfg: ArchConfig, model: GR.GRModel, table: Any, *,
                 max_users: int = 256, k: int = 100,
                 retrieval_block: int = 4096, use_shadow: bool = True,
                 max_rows_per_tick: int = 32,
                 max_tokens_per_tick: Optional[int] = None,
                 queue_limit: Optional[int] = None,
                 admission: str = "evict",
                 prefix_reuse: bool = True,
                 attn_fn: Optional[Callable] = None,
                 device: DeviceLike = None, obs: Optional[Obs] = None):
        if admission not in ("evict", "shed"):
            raise ValueError(f"admission policy {admission!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.obs = obs
        self._span, self._mx = _obs_hooks(obs)
        self.table = _serving_table(model, table, use_shadow, self.device)
        self.k = k
        self.admission = admission
        # the warm path needs per-layer K/V projections, which only the
        # HSTU block exposes: other blocks serve cold-only
        self.prefix_reuse = bool(prefix_reuse) and cfg.gr_block == "hstu"
        S = cfg.max_seq_len
        dqk = cfg.qkv_dim or cfg.resolved_head_dim
        kv_shape = ((cfg.num_layers, cfg.num_heads, dqk, dqk)
                    if self.prefix_reuse else None)
        self._dtype = GR.torch_dtype(cfg.dtype)
        self.buffer = SequenceBuffer(max_users, S, cfg.d_model,
                                     dtype=self._dtype, kv_shape=kv_shape,
                                     device=self.device)
        self.sched = ContinuousScheduler(
            max_rows_per_tick=max_rows_per_tick,
            max_tokens_per_tick=max_tokens_per_tick,
            queue_limit=(queue_limit if queue_limit is not None
                         else max(4 * max_users, 64)))
        # one ladder for the encode rows and the retrieval batch; another
        # for the warm window (tokens), at least 2 wide, as the JAX
        # package's (the row-local dense ops give a row the cold encode's
        # bits at any row count, hstu._row_stats)
        self.row_ladder = BucketLadder(max_rows_per_tick)
        self.q_ladder = BucketLadder(S, min_size=min(2, S))
        self.compile_cache = CompileCache()
        self.retriever = ShardedTopK(
            k, block_v=min(retrieval_block, self.table.master.shape[0]),
            use_shadow=use_shadow)
        self._block_v = self.retriever.block_v
        self._scan = self.retriever.scan_table(self.table)
        self.attn_fn = attn_fn or GR.default_attn_fn(cfg)
        self.graph_captures = 0
        # host mirror of the embedding rows, filled at rank time: what
        # cache-hit results carry without touching the device
        self._h_emb: Dict[int, np.ndarray] = {}
        # (rid, user, slot, (ids, scores)) answered from the top-k cache
        self._ready: List[Tuple[int, int, int,
                                Tuple[np.ndarray, np.ndarray]]] = []
        self.warm_rows = self.cold_rows = 0
        self.warm_tokens = self.cold_tokens = 0
        self.rank_batches = 0

    # -- device steps ------------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def _cold_step(self, rows, row_ids, row_ts, lengths) -> None:
        """Full encode of R slot rows (R, S): the device rows, the
        embeddings and (prefix reuse) every layer's K/V caches."""
        b = self.buffer
        r = rows.long()
        b.tokens[r] = row_ids
        b.timestamps[r] = row_ts
        x = ET.lookup(self.table.master, row_ids, dtype=self._dtype)
        if self.prefix_reuse:
            e = GR.gr_encode_slots(self.model, self.cfg, x, row_ts, lengths,
                                   b.kv_k, b.kv_v, rows,
                                   attn_fn=self.attn_fn)
        else:
            e = GR.gr_encode_slots_flat(self.model, self.cfg, x, row_ts,
                                        lengths, attn_fn=self.attn_fn)
        b.emb[r] = e

    @torch.no_grad()
    def _warm_step(self, rows, new_ids, new_ts, pref, nnew) -> None:
        """Scatter each row's append window (R, Q) into its device rows,
        then encode only that window against the cached prefix."""
        b = self.buffer
        r = rows.long()
        at = pref.long()[:, None] + torch.arange(new_ids.shape[1],
                                                 device=self.device)
        b.tokens[r[:, None], at] = new_ids
        b.timestamps[r[:, None], at] = new_ts
        x_new = ET.lookup(self.table.master, new_ids, dtype=self._dtype)
        e = GR.gr_append_slots(self.model, self.cfg, x_new, b.timestamps[r],
                               b.kv_k, b.kv_v, rows, pref, nnew)
        b.emb[r] = e

    @torch.no_grad()
    def _rank_step(self, rows):
        return RT.topk_from_slots(self.buffer.emb, rows, self._scan,
                                  k=self.k, block_v=self._block_v)

    def _rank_fn(self, B: int) -> Callable:
        """The rank step for B rows: on the card its captured graph, else
        the eager step."""
        def build():
            if self.device.type != "cuda":
                return self._rank_step
            self.graph_captures += 1
            return _RankGraph(self._rank_step, self._pad_rows(B))
        return self.compile_cache.get("rank", (B,), build)

    def _pad_rows(self, R: int) -> torch.Tensor:
        return torch.full((R,), self.buffer.pad_row, dtype=torch.int32,
                          device=self.device)

    def warmup(self, q_caps: Sequence[int] = ()) -> int:
        """Run every step once at every row rung against the scratch row:
        cold encode and rank, plus (prefix reuse) each warm window bucket
        in ``q_caps``. On the card this captures the rank graphs, so
        steady-state traffic never stalls on a capture. Returns the number
        of step entries built."""
        b = self.buffer
        S = b.max_seq_len
        before = self.compile_cache.compiles
        qs = sorted({self.q_ladder.bucket(q) for q in q_caps})
        for R in self.row_ladder.rungs:
            rows = self._pad_rows(R)
            zeros = torch.zeros((R, S), dtype=torch.int32, device=self.device)
            ones = torch.ones(R, dtype=torch.int32, device=self.device)
            self.compile_cache.get("cold", (R,), lambda: self._cold_step)(
                rows, zeros, zeros, ones)
            if self.prefix_reuse:
                for q in qs:
                    self.compile_cache.get(
                        "warm", (R, q), lambda: self._warm_step)(
                            rows, zeros[:, :q], zeros[:, :q], 0 * ones, ones)
            self._rank_fn(R)(rows)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_cache.compiles - before

    # -- request side ------------------------------------------------------

    def submit(self, user: int, new_ids: Sequence[int] = (),
               new_ts: Sequence[int] = (), *,
               now: Optional[float] = None) -> Admission:
        """Open-loop admission of one request. Never blocks, never raises
        on overload: returns a typed :class:`Admission`. Malformed input
        (mismatched delta, unknown user with no history) still raises:
        that is a caller bug, not traffic."""
        now = time.monotonic() if now is None else now
        ids = np.asarray(new_ids, np.int32)
        ts = np.asarray(new_ts, np.int32)
        if ids.size != ts.size:
            raise ValueError(f"user {user}: event delta mismatch: "
                             f"{ids.size} ids, {ts.size} ts")
        slot = self.buffer.slot_of(user)
        if slot is None:
            if self.buffer.take_evicted(user):
                # the delta cannot rebuild an evicted history: a typed
                # outcome (reported once per eviction), not an exception
                self.sched.shed("resend_full")
                return Admission(None, "resend_full", user)
            if ids.size == 0:
                raise ValueError(f"user {user}: request with no history")
            if not self.sched.has_capacity():
                self.sched.shed("shed_queue")
                return Admission(None, "shed_queue", user)
            slot = self.buffer.alloc(user, evict=(self.admission == "evict"),
                                     busy=self.sched.busy_slots())
            if slot is None:
                self.sched.shed("shed_slots")
                return Admission(None, "shed_slots", user)
            self.buffer.seed(slot, ids, ts)
            rid = self.sched.admit(user, now)
            self.sched.enqueue(slot, rid)
            return Admission(rid, "accepted", user)
        if not self.sched.has_capacity():
            self.sched.shed("shed_queue")
            return Admission(None, "shed_queue", user)
        self.buffer.touch(slot)
        if ids.size:
            self.buffer.append(slot, ids, ts)
            rid = self.sched.admit(user, now)
            self.sched.enqueue(slot, rid)
            return Admission(rid, "accepted", user)
        if self.buffer.emb_fresh(slot):
            rid = self.sched.admit(user, now, hit=True)
            cached = self.buffer.topk(slot)
            if cached is not None:
                # pure hit: a version-current top-k that never touches the
                # device, dispatched the instant it was admitted
                self.sched.records[rid]["t_dispatch"] = now
                self._ready.append((rid, user, slot, cached))
            else:
                self.sched.enqueue_rank(slot, rid)
            return Admission(rid, "accepted", user, hit=True)
        # no new events but a stale embedding (events arrived earlier and
        # the slot has not ticked yet): join the slot's encode work
        rid = self.sched.admit(user, now)
        self.sched.enqueue(slot, rid)
        return Admission(rid, "accepted", user)

    # -- tick --------------------------------------------------------------

    def _cost_of(self, slot: int) -> Tuple[str, int]:
        pend = self.buffer.pending_new(slot)
        if (self.prefix_reuse and pend > 0
                and self.buffer.warm_eligible(
                    slot, self.q_ladder.bucket(min(pend,
                                                  self.buffer.max_seq_len)))):
            return "warm", pend
        return "cold", max(int(self.buffer.length[slot]), 1)

    def tick(self, *, now: Optional[float] = None) -> List[ServeResult]:
        """Run one continuous-batching step: form a budget-bounded tick,
        encode its cold and warm rows, rank every finished slot from the
        device embedding buffer, and return results in rid order. Without
        ``now`` the requests are dispatched at the tick's start and done
        at its end, on the host's monotonic clock (after the results
        reached the host)."""
        with self._span("tick", "serve"):
            return self._tick(now=now)

    def _tick(self, *, now: Optional[float] = None) -> List[ServeResult]:
        given = now
        now = time.monotonic() if now is None else now
        results: List[ServeResult] = []
        for rid, user, slot, (tids, tscores) in self._ready:
            results.append(ServeResult(
                rid=rid, user=user, item_ids=tids.copy(),
                scores=tscores.copy(), user_emb=self._h_emb[slot].copy(),
                cache_hit=True))
        self._ready = []
        plan = self.sched.form_tick(now, self._cost_of)
        rank_items: List[Tuple[int, List[int], bool]] = []
        if not plan.empty:
            warm, cold = plan.warm, list(plan.cold)
            q_cap = 0
            if warm:
                q_cap = self.q_ladder.bucket(
                    max(max(self.buffer.pending_new(s) for s, _ in warm), 1))
                # demote rows the bucketed window no longer fits (the
                # per-slot eligibility probe used a smaller bucket)
                keep = []
                for slot, rids in warm:
                    if self.buffer.warm_eligible(slot, q_cap):
                        keep.append((slot, rids))
                    else:
                        cold.append((slot, rids))
                warm = keep
            if cold:
                self._run_cold(cold)
            if warm:
                self._run_warm(warm, q_cap)
            for slot, rids in cold + warm:
                rank_items.append((slot, rids, False))
        for slot, rids in plan.rank_only:
            rank_items.append((slot, rids, True))
        if rank_items:
            results.extend(self._rank(rank_items))
        self.sched.mark_done([r.rid for r in results],
                             now=time.monotonic() if given is None else now)
        results.sort(key=lambda r: r.rid)
        return results

    def _rows(self, slots: List[int]) -> Tuple[int, np.ndarray]:
        R = self.row_ladder.bucket(len(slots))
        rows = np.full(R, self.buffer.pad_row, np.int32)
        rows[:len(slots)] = slots
        return R, rows

    def _run_cold(self, items: List[Tuple[int, List[int]]]) -> None:
        with self._span("encode_cold", "serve_encode", rows=len(items)):
            self._run_cold_impl(items)

    def _run_cold_impl(self, items: List[Tuple[int, List[int]]]) -> None:
        b = self.buffer
        slots = [s for s, _ in items]
        R, rows = self._rows(slots)
        S = b.max_seq_len
        row_ids = np.zeros((R, S), np.int32)
        row_ts = np.zeros((R, S), np.int32)
        lengths = np.zeros(R, np.int32)
        for i, s in enumerate(slots):
            row_ids[i] = b.h_ids[s]
            row_ts[i] = b.h_ts[s]
            lengths[i] = b.length[s]
        fn = self.compile_cache.get("cold", (R,), lambda: self._cold_step)
        fn(self._t(rows), self._t(row_ids), self._t(row_ts),
           self._t(lengths))
        for s in slots:
            b.mark_encoded(s)
        self.cold_rows += len(slots)
        self.cold_tokens += int(lengths.sum())

    def _run_warm(self, items: List[Tuple[int, List[int]]],
                  q_cap: int) -> None:
        with self._span("encode_warm", "serve_encode",
                        rows=len(items), q_cap=q_cap):
            self._run_warm_impl(items, q_cap)

    def _run_warm_impl(self, items: List[Tuple[int, List[int]]],
                       q_cap: int) -> None:
        b = self.buffer
        slots = [s for s, _ in items]
        R, rows = self._rows(slots)
        new_ids = np.zeros((R, q_cap), np.int32)
        new_ts = np.zeros((R, q_cap), np.int32)
        pref = np.zeros(R, np.int32)
        nnew = np.zeros(R, np.int32)
        for i, s in enumerate(slots):
            el, L = int(b.enc_len[s]), int(b.length[s])
            new_ids[i, :L - el] = b.h_ids[s, el:L]
            new_ts[i, :L - el] = b.h_ts[s, el:L]
            pref[i] = el
            nnew[i] = L - el
            self.warm_tokens += L - el
        fn = self.compile_cache.get("warm", (R, q_cap),
                                    lambda: self._warm_step)
        fn(self._t(rows), self._t(new_ids), self._t(new_ts), self._t(pref),
           self._t(nnew))
        for s in slots:
            b.mark_encoded(s)
        self.warm_rows += len(slots)

    def _rank(self, items: List[Tuple[int, List[int], bool]]
              ) -> List[ServeResult]:
        """Rank finished slots straight from the device embedding buffer,
        in row-ladder-bounded bucketed chunks."""
        with self._span("rank", "serve_rank", slots=len(items)):
            return self._rank_impl(items)

    def _rank_impl(self, items: List[Tuple[int, List[int], bool]]
                   ) -> List[ServeResult]:
        results: List[ServeResult] = []
        cap = self.row_ladder.max_size
        for lo in range(0, len(items), cap):
            chunk = items[lo:lo + cap]
            slots = [s for s, _, _ in chunk]
            B, rows = self._rows(slots)
            vals, idx, q = self._rank_fn(B)(self._t(rows))
            self.rank_batches += 1
            n = len(slots)
            vals = vals[:n].cpu().numpy()
            idx = idx[:n].cpu().numpy()
            q = q[:n].float().cpu().numpy()
            for i, (slot, rids, hit) in enumerate(chunk):
                self.buffer.store_topk(slot, idx[i], vals[i])
                self._h_emb[slot] = q[i]
                user = int(self.buffer.user[slot])
                for rid in rids:
                    results.append(ServeResult(
                        rid=rid, user=user, item_ids=idx[i].copy(),
                        scores=vals[i].copy(), user_emb=q[i].copy(),
                        cache_hit=hit))
        return results

    # -- convenience / accounting ------------------------------------------

    @property
    def pending(self) -> bool:
        return bool(self._ready or self.sched.queued_slots
                    or self.sched._rank_only)

    def serve(self, requests: Sequence[Tuple[int, Sequence[int],
                                             Sequence[int]]], *,
              now: Optional[float] = None) -> List[ServeResult]:
        """Closed-loop convenience: submit every ``(user, new_ids,
        new_ts)`` triple, tick until drained, return results in rid order.
        Raises if any request is shed: closed-loop traces must size
        capacity so that nothing sheds."""
        admissions = [self.submit(u, i, t, now=now) for u, i, t in requests]
        rejected = [a for a in admissions if not a.accepted]
        if rejected:
            raise RuntimeError(
                f"closed-loop serve shed {len(rejected)} requests: "
                f"{[(a.user, a.outcome) for a in rejected]}")
        out: List[ServeResult] = []
        while self.pending:
            out.extend(self.tick(now=now))
        out.sort(key=lambda r: r.rid)
        return out

    def stats(self) -> Dict[str, Any]:
        out = {
            "latency": self.sched.latency_stats(),
            "admission": dict(self.sched.outcomes),
            "occupancy": {**self.sched.occupancy(), **self.buffer.stats()},
            "compile": {**self.compile_cache.stats(),
                        "graph_captures": self.graph_captures},
            "encode": {"warm_rows": self.warm_rows,
                       "cold_rows": self.cold_rows,
                       "warm_tokens": self.warm_tokens,
                       "cold_tokens": self.cold_tokens,
                       "rank_batches": self.rank_batches,
                       "prefix_reuse": self.prefix_reuse},
            "retrieval_table_dtype": str(self._scan.dtype),
        }
        if self._mx is not None:
            # mirrored into the registry; the dict is returned unchanged
            self._mx.publish("serve", out)
        return out
