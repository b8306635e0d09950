"""Persistent device-resident user state for continuous-batching serving
(the port of the JAX package's ``serving/slot_buffer.py``).

:class:`SequenceBuffer` keeps user sequences on the device in slot-indexed
``(max_users+1, max_seq_len)`` token/timestamp tensors (one user per row,
chronological, position 0 oldest), beside per-slot embedding rows and,
for the incremental warm path, per-layer K/V prefix caches. The host keeps
the free-slot map, per-slot length/version scalars and a numpy mirror of
the token/timestamp rows (what cold re-encodes and evict/re-admit cycles
are rebuilt from).

Row ``max_users`` is a scratch lane: bucketed ticks pad their row lists
with it, so pad-lane writes land somewhere harmless. Timestamps are kept
raw: the relative bias reads only their differences.

The K/V caches are laid out layer first, ``(L, max_users+1, cap, H, D)``
with cap = max_seq_len rounded up to the kernel's 128-row tile, so a
layer's cache is one ``(max_users+1, cap, H, D)`` tensor that K1-fwd's
append launch reads by slot index (the reference's is slot first,
``(N+1, L, S, H, D)``). They start zeroed and only ever receive computed
projections: a value past a row's length is finite, so a masked key adds
an exact zero (0·NaN would be NaN).

Also here: :class:`BucketLadder` (the bounded power-of-two shape ladder
shared by encode and retrieval) and :class:`CompileCache` (the per-bucket
step cache whose counts the engine reports; on the card its rank entries
are captured CUDA graphs).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.gr import slot_capacity

__all__ = ["BucketLadder", "CompileCache", "SequenceBuffer"]


class BucketLadder:
    """Bounded power-of-two bucket ladder: ``bucket(n)`` rounds a dynamic
    size up to the smallest rung ≥ n, so every step shape comes from a
    fixed, small set."""

    def __init__(self, max_size: int, min_size: int = 1):
        if max_size < 1 or min_size < 1 or min_size > max_size:
            raise ValueError((min_size, max_size))
        rungs: List[int] = []
        b = 1
        while b < min_size:
            b *= 2
        while b < max_size:
            rungs.append(b)
            b *= 2
        rungs.append(max_size)
        self.rungs: Tuple[int, ...] = tuple(rungs)
        self.max_size = max_size

    def bucket(self, n: int) -> int:
        if n > self.max_size:
            raise ValueError(f"size {n} exceeds ladder max {self.max_size}")
        for r in self.rungs:
            if r >= n:
                return r
        return self.max_size  # pragma: no cover (max rung always matches)


class CompileCache:
    """Per-(step, bucket) cache of what a step runs: ``get(name, key,
    build)`` returns the cached entry, building (and counting) it on first
    use; ``stats()`` gives the counts the engine reports. The JAX package
    caches compiled programs here; the port caches the eager step (cold,
    warm) or, on the card, the rank step's captured CUDA graph."""

    def __init__(self):
        self._fns: Dict[Tuple[Any, ...], Callable] = {}
        self.calls = 0

    def get(self, name: str, key: Tuple[Any, ...],
            build: Callable[[], Callable]) -> Callable:
        k = (name,) + tuple(key)
        fn = self._fns.get(k)
        if fn is None:
            fn = self._fns[k] = build()
        self.calls += 1
        return fn

    @property
    def compiles(self) -> int:
        return len(self._fns)

    def stats(self) -> Dict[str, Any]:
        per_name: Dict[str, int] = {}
        for k in self._fns:
            per_name[k[0]] = per_name.get(k[0], 0) + 1
        return {"compiles": len(self._fns), "calls": self.calls,
                "per_fn": per_name}


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class SequenceBuffer:
    """Slot-indexed persistent user state: device tensors on ``device`` +
    the host free map and numpy mirrors.

    Invariants (tested in tests/test_torch_serving_stream.py):

      * every live user maps to exactly one slot; free ∪ live is a
        partition of [0, max_users);
      * ``0 < length[slot] ≤ max_seq_len`` for live slots and the host
        mirror's first ``length`` positions hold the newest events in
        chronological order (ring semantics: an overflowing append keeps
        the last ``max_seq_len`` events);
      * ``version[slot]`` strictly increases with every state change of
        the slot's user, and ``enc_version[slot] == version[slot]`` iff
        the device embedding row is fresh;
      * an evicted user is reported exactly once via ``take_evicted`` and
        must then be re-seeded with full history.
    """

    def __init__(self, max_users: int, max_seq_len: int, d_model: int,
                 *, dtype="bfloat16",
                 kv_shape: Optional[Tuple[int, int, int, int]] = None,
                 kv_dtype=None, device="cpu"):
        if max_users < 1 or max_seq_len < 1:
            raise ValueError((max_users, max_seq_len))
        self.max_users = int(max_users)
        self.max_seq_len = int(max_seq_len)
        self.d_model = int(d_model)
        self.device = torch.device(device)
        N, S = self.max_users, self.max_seq_len
        dt = _torch_dtype(dtype)
        dev = dict(device=self.device)

        # device state; row N is the scratch lane for bucketed-tick padding
        self.tokens = torch.zeros((N + 1, S), dtype=torch.int32, **dev)
        self.timestamps = torch.zeros((N + 1, S), dtype=torch.int32, **dev)
        self.emb = torch.zeros((N + 1, d_model), dtype=dt, **dev)
        self.kv_k = self.kv_v = None
        if kv_shape is not None:
            L, H, dqk, dv = kv_shape
            if dqk != dv:
                raise ValueError(f"K/V head dims {dqk} != {dv}")
            cap = slot_capacity(S)
            kdt = _torch_dtype(kv_dtype or dt)
            self.kv_k = torch.zeros((L, N + 1, cap, H, dqk), dtype=kdt, **dev)
            self.kv_v = torch.zeros((L, N + 1, cap, H, dv), dtype=kdt, **dev)

        # host mirrors + per-slot scalars
        self.h_ids = np.zeros((N, S), np.int32)
        self.h_ts = np.zeros((N, S), np.int32)
        self.user = np.full(N, -1, np.int64)
        self.length = np.zeros(N, np.int32)
        self.version = np.zeros(N, np.int64)
        self.enc_len = np.full(N, -1, np.int32)     # tokens covered by emb/kv
        self.enc_version = np.full(N, -1, np.int64)
        self.needs_cold = np.zeros(N, bool)         # seed/truncate → full encode
        self.last_used = np.zeros(N, np.int64)

        self._slot_of: Dict[int, int] = {}
        self._free: List[int] = list(range(N - 1, -1, -1))
        self._evicted: set = set()
        self._topk: Dict[int, Tuple[np.ndarray, np.ndarray, int]] = {}
        self._clock = 0
        self.evictions = 0

    # -- slot map ----------------------------------------------------------

    @property
    def pad_row(self) -> int:
        return self.max_users

    @property
    def slots_used(self) -> int:
        return self.max_users - len(self._free)

    def slot_of(self, user: int) -> Optional[int]:
        return self._slot_of.get(int(user))

    def take_evicted(self, user: int) -> bool:
        """One-shot handshake: True exactly once after ``user`` was evicted
        — the caller must answer with a full-history re-seed."""
        user = int(user)
        if user in self._evicted:
            self._evicted.discard(user)
            return True
        return False

    def touch(self, slot: int) -> None:
        self._clock += 1
        self.last_used[slot] = self._clock

    def alloc(self, user: int, *, evict: bool = True,
              busy: Iterable[int] = ()) -> Optional[int]:
        """Claim a slot for a new user: free list first, else (``evict``)
        the least-recently-used idle slot not in ``busy``. Returns None
        when nothing can be claimed (the caller sheds the request)."""
        user = int(user)
        if user in self._slot_of:
            raise ValueError(f"user {user} already resident")
        if self._free:
            slot = self._free.pop()
        elif evict:
            busy = set(busy)
            order = np.argsort(self.last_used, kind="stable")
            slot = next((int(s) for s in order if int(s) not in busy), None)
            if slot is None:
                return None
            self.evict(slot)
            self._free.pop()
        else:
            return None
        self._slot_of[user] = slot
        self.user[slot] = user
        self.touch(slot)
        return slot

    def _clear(self, slot: int) -> None:
        self.user[slot] = -1
        self.length[slot] = 0
        self.version[slot] = 0
        self.enc_len[slot] = -1
        self.enc_version[slot] = -1
        self.needs_cold[slot] = False
        self._topk.pop(slot, None)
        self._free.append(slot)

    def evict(self, slot: int) -> None:
        """Drop the slot's user (host side only: the device rows become
        stale, finite values that masked attention renders harmless)."""
        old = int(self.user[slot])
        if old >= 0:
            self._slot_of.pop(old, None)
            self._evicted.add(old)
            self.evictions += 1
        self._clear(slot)

    def release(self, user: int) -> None:
        """Graceful free (no evicted handshake): the user just leaves."""
        self._clear(self._slot_of.pop(int(user)))

    # -- event state -------------------------------------------------------

    def seed(self, slot: int, ids: np.ndarray, ts: np.ndarray) -> None:
        """Install a full history into a freshly claimed slot (newest last;
        only the last ``max_seq_len`` events are kept)."""
        S = self.max_seq_len
        ids = np.asarray(ids, np.int32)[-S:]
        ts = np.asarray(ts, np.int32)[-S:]
        n = ids.shape[0]
        if n == 0:
            raise ValueError("seed with empty history")
        self.h_ids[slot, :n] = ids
        self.h_ts[slot, :n] = ts
        self.length[slot] = n
        self.version[slot] += 1
        self.needs_cold[slot] = True
        self._topk.pop(slot, None)

    def append(self, slot: int, ids: np.ndarray, ts: np.ndarray) -> None:
        """Append new events to a live slot (ring semantics: keep the last
        ``max_seq_len``). A wraparound or truncation invalidates the
        prefix: the slot falls back to a cold full encode at its next
        tick."""
        ids = np.asarray(ids, np.int32)
        ts = np.asarray(ts, np.int32)
        n = ids.shape[0]
        if n == 0:
            return
        S = self.max_seq_len
        L = int(self.length[slot])
        total = L + n
        if n >= S:
            self.h_ids[slot] = ids[-S:]
            self.h_ts[slot] = ts[-S:]
            self.length[slot] = S
            self.needs_cold[slot] = True
        elif total > S:
            drop = total - S
            keep = L - drop
            self.h_ids[slot, :keep] = self.h_ids[slot, drop:L]
            self.h_ts[slot, :keep] = self.h_ts[slot, drop:L]
            self.h_ids[slot, keep:] = ids
            self.h_ts[slot, keep:] = ts
            self.length[slot] = S
            self.needs_cold[slot] = True
        else:
            self.h_ids[slot, L:total] = ids
            self.h_ts[slot, L:total] = ts
            self.length[slot] = total
        self.version[slot] += 1
        self._topk.pop(slot, None)

    def pending_new(self, slot: int) -> int:
        """Events appended since the device prefix was last encoded (only
        meaningful when the slot is warm-eligible)."""
        return int(self.length[slot]) - max(int(self.enc_len[slot]), 0)

    def warm_eligible(self, slot: int, q_cap: int) -> bool:
        """Warm iff the device prefix is valid and the bucketed append
        window fits the row: ``enc_len + q_cap ≤ S``."""
        if self.kv_k is None or self.needs_cold[slot]:
            return False
        el = int(self.enc_len[slot])
        if el <= 0 or int(self.enc_version[slot]) < 0:
            return False
        return el + q_cap <= self.max_seq_len

    def mark_encoded(self, slot: int) -> None:
        self.enc_len[slot] = self.length[slot]
        self.enc_version[slot] = self.version[slot]
        self.needs_cold[slot] = False

    def emb_fresh(self, slot: int) -> bool:
        return (int(self.enc_version[slot]) == int(self.version[slot])
                and int(self.enc_len[slot]) == int(self.length[slot]))

    # -- host top-k cache --------------------------------------------------

    def store_topk(self, slot: int, ids: np.ndarray,
                   scores: np.ndarray) -> None:
        self._topk[slot] = (ids, scores, int(self.version[slot]))

    def topk(self, slot: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        hit = self._topk.get(slot)
        if hit is None or hit[2] != int(self.version[slot]):
            return None
        return hit[0], hit[1]

    # -- accounting --------------------------------------------------------

    @property
    def device_bytes(self) -> int:
        ts = (self.tokens, self.timestamps, self.emb, self.kv_k, self.kv_v)
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def stats(self) -> Dict[str, Any]:
        return {
            "max_users": self.max_users,
            "slots_used": self.slots_used,
            "occupancy": self.slots_used / self.max_users,
            "evictions": self.evictions,
            "device_bytes": self.device_bytes,
        }
