"""Batched recall-serving engine: scheduler → cached jagged encode →
sharded quantized top-k.

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

``user_emb`` in a result is an fp32 numpy array holding the model dtype's
values (numpy has no bfloat16).
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
from repro_torch.serving.retrieval import ShardedTopK
from repro_torch.serving.scheduler import RequestScheduler
from repro_torch.serving.state_cache import UserStateCache


@dataclass
class ServeResult:
    rid: int
    user: int
    item_ids: np.ndarray      # (k,) int32, score-descending
    scores: np.ndarray        # (k,) fp32
    user_emb: np.ndarray      # (d,) the representation that was ranked
    cache_hit: bool


def _bucket(n: int) -> int:
    """Next power-of-two ≥ n: retrieval batches come in log₂ sizes."""
    b = 1
    while b < n:
        b <<= 1
    return b


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
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        if isinstance(table, ET.ShadowedTable):
            self.table = table
        else:
            # serving-only construction from a raw master: no (V, D) fp32
            # AdaGrad accumulator, and the fp16 shadow only if retrieval
            # will scan it
            self.table = ET.ShadowedTable(
                master=table,
                shadow=table.to(torch.float16) if use_shadow else None,
                accum=torch.zeros((0, table.shape[-1]), dtype=torch.float32,
                                  device=table.device))
        for name, t in (("model", next(model.parameters())),
                        ("table", self.table.master)):
            if t.device.type != self.device.type:
                raise ValueError(f"{name} lies on {t.device}, the engine "
                                 f"runs on {self.device}")
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
            d = pending[0][3].shape[-1]
            E = np.zeros((_bucket(B), d), np.float32)
            E[:B] = np.stack([p[3] for p in pending]).astype(np.float32)
            vals, idx = self.retriever(self.table,
                                       torch.from_numpy(E).to(self.device))
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
        return {"latency": self.scheduler.latency_stats(),
                "cache": self.cache.stats(),
                "encoded_batches": self.encoded_batches,
                "retrieval_table_dtype":
                    str(self.retriever.scan_table(self.table).dtype)}
