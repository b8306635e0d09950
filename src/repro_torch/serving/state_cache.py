"""Incremental user-state cache — the serving engine's memory of users.

Returning users dominate recommendation traffic: most requests carry only
a handful of *new* events on top of a history the engine has already seen.
The cache keeps, per user:

  * the jagged history itself in a fixed-size **ring buffer** truncated at
    ``max_seq_len`` (appends are O(new events), never a realloc — the same
    "keep the last max_seq_len tokens" contract the training loader
    enforces), and
  * the last encoded user embedding, stamped with the history version it
    was computed from.

A request whose user has no new events and a version-current embedding is
a **cache hit**: the engine skips re-tokenization and re-encoding entirely
and goes straight to retrieval. A request with new events appends them
(ring-buffer truncation) and re-encodes — the cached history means the
client only ships the delta, not the full log.

Optional LRU bound (``max_users``): production tables hold millions of
users; the cache evicts least-recently-used states beyond the bound.
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


class UserState:
    """Per-user ring buffer over (item id, timestamp) events + cached
    embedding. ``history()`` returns the chronological view."""

    __slots__ = ("ids", "ts", "head", "count", "emb", "version",
                 "emb_version", "topk_ids", "topk_scores", "topk_version")

    def __init__(self, max_len: int):
        self.ids = np.zeros((max_len,), np.int32)
        self.ts = np.zeros((max_len,), np.int32)
        self.head = 0            # next write slot
        self.count = 0           # live events (≤ max_len)
        self.emb: Optional[np.ndarray] = None
        self.version = 0         # bumped on every append
        self.emb_version = -1    # version emb was encoded from
        self.topk_ids: Optional[np.ndarray] = None
        self.topk_scores: Optional[np.ndarray] = None
        self.topk_version = -1   # version the top-k was ranked from

    @property
    def max_len(self) -> int:
        return self.ids.shape[0]

    def append(self, new_ids: Sequence[int], new_ts: Sequence[int]) -> None:
        new_ids = np.asarray(new_ids, np.int32)
        new_ts = np.asarray(new_ts, np.int32)
        if new_ids.size != new_ts.size:   # validate before any write — a
            raise ValueError(             # partial append would corrupt
                f"event delta mismatch: {new_ids.size} ids, "
                f"{new_ts.size} ts")      # the buffer at an old version
        if new_ids.size == 0:
            return
        m = self.max_len
        if new_ids.size >= m:               # whole buffer replaced
            self.ids[:] = new_ids[-m:]
            self.ts[:] = new_ts[-m:]
            self.head, self.count = 0, m
        else:
            n = new_ids.size
            end = self.head + n
            if end <= m:
                self.ids[self.head:end] = new_ids
                self.ts[self.head:end] = new_ts
            else:                            # wrap
                k = m - self.head
                self.ids[self.head:] = new_ids[:k]
                self.ts[self.head:] = new_ts[:k]
                self.ids[:end - m] = new_ids[k:]
                self.ts[:end - m] = new_ts[k:]
            self.head = end % m
            self.count = min(self.count + n, m)
        self.version += 1

    def history(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, ts) chronological, oldest retained event first."""
        if self.count < self.max_len:
            return self.ids[:self.count].copy(), self.ts[:self.count].copy()
        order = np.r_[self.head:self.max_len, 0:self.head]
        return self.ids[order], self.ts[order]

    def fresh_embedding(self) -> Optional[np.ndarray]:
        """The cached embedding iff it matches the current history."""
        if self.emb is not None and self.emb_version == self.version:
            return self.emb
        return None

    def store_embedding(self, emb: np.ndarray,
                        version: Optional[int] = None) -> None:
        """``version`` is the history version the embedding was *encoded
        from* (snapshotted when the encode was requested) — stamping the
        current version would mark an embedding fresh even though events
        arrived while it was in flight. Out-of-order stores (two requests
        for one user in the same micro-batch) keep the newest version."""
        version = self.version if version is None else version
        if version < self.emb_version:
            return
        self.emb = np.asarray(emb)
        self.emb_version = version

    def fresh_topk(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Cached (item ids, scores) iff ranked from the current history —
        with a static model/table, a version-current top-k is bit-identical
        to re-ranking, so the hit path can skip the table scan entirely."""
        if self.topk_ids is not None and self.topk_version == self.version:
            return self.topk_ids, self.topk_scores
        return None

    def store_topk(self, item_ids: np.ndarray, scores: np.ndarray,
                   version: Optional[int] = None) -> None:
        """Same snapshot-version contract as :meth:`store_embedding`."""
        version = self.version if version is None else version
        if version < self.topk_version:
            return
        # np.array (copy), not asarray: the caller usually passes row
        # views of a shared retrieval batch — aliasing them here would
        # pin the whole batch and let result mutation corrupt the cache
        self.topk_ids = np.array(item_ids)
        self.topk_scores = np.array(scores)
        self.topk_version = version


class UserStateCache:
    """user id → :class:`UserState`, with hit/miss accounting and an
    optional LRU bound."""

    def __init__(self, max_seq_len: int, *, max_users: Optional[int] = None):
        self.max_seq_len = max_seq_len
        self.max_users = max_users
        self._states: "OrderedDict[int, UserState]" = OrderedDict()
        # users whose state was LRU-evicted and who have not re-seeded
        # yet: a later delta-only request cannot reconstruct their
        # history, so callers must be able to tell "new user" from
        # "evicted user" (ints only; cleared on take_evicted/re-seed)
        self._evicted: set = set()
        self._pinned: set = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._states)

    def __contains__(self, user: int) -> bool:
        return user in self._states

    def _touch(self, user: int) -> UserState:
        st = self._states.get(user)
        if st is None:
            st = UserState(self.max_seq_len)
            self._states[user] = st
            self._evicted.discard(user)
            # evict least-recently-used *unpinned* users down to the
            # bound; with everything pinned (a batch larger than the
            # bound) the cache transiently overshoots — max_users is a
            # soft bound, and the `while` drains the overshoot on the
            # first insert after the pins release
            while self.max_users and len(self._states) > self.max_users:
                gone = next((u for u in self._states
                             if u not in self._pinned), None)
                if gone is None:
                    break
                del self._states[gone]
                self._evicted.add(gone)
                self.evictions += 1
        else:
            self._states.move_to_end(user)
        return st

    @contextmanager
    def pinned(self, users: Iterable[int]):
        """Protect ``users`` from LRU eviction for the duration — a batch
        being served must not evict its own members mid-flight."""
        prev = self._pinned
        self._pinned = prev | set(users)
        try:
            yield
        finally:
            self._pinned = prev

    def is_evicted(self, user: int) -> bool:
        """Non-mutating peek of the evicted flag (validation passes that
        must not consume the one-rejection handshake use this)."""
        return user in self._evicted

    def take_evicted(self, user: int) -> bool:
        """True iff ``user``'s state was evicted since they last seeded —
        and clears the flag, so the caller's one rejection lets the
        user's retry re-seed with a full history."""
        if user in self._evicted:
            self._evicted.discard(user)
            return True
        return False

    def update(self, user: int, new_ids: Sequence[int] = (),
               new_ts: Sequence[int] = ()) -> Tuple[UserState, bool]:
        """Merge a request's new events into the user's state.

        Returns ``(state, needs_encode)`` — ``needs_encode`` is False only
        on a cache hit: no new events *and* a version-current embedding.
        Hit/miss counters are updated here (one decision per request).
        """
        new_ids = np.asarray(new_ids, np.int32)
        new_ts = np.asarray(new_ts, np.int32)
        if new_ids.size != new_ts.size:
            # reject BEFORE _touch: a malformed request must not insert an
            # empty state (or LRU-evict a warm user) on its way to failing
            raise ValueError(f"event delta mismatch: {new_ids.size} ids, "
                             f"{new_ts.size} ts")
        st = self._touch(user)
        st.append(new_ids, new_ts)
        if st.fresh_embedding() is not None:
            self.hits += 1
            return st, False
        self.misses += 1
        return st, True

    def store(self, user: int, emb: np.ndarray,
              version: Optional[int] = None) -> None:
        st = self._states.get(user)
        if st is not None:
            st.store_embedding(emb, version)

    def store_topk(self, user: int, item_ids: np.ndarray,
                   scores: np.ndarray,
                   version: Optional[int] = None) -> None:
        st = self._states.get(user)
        if st is not None:
            st.store_topk(item_ids, scores, version)

    def get(self, user: int) -> Optional[UserState]:
        return self._states.get(user)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {"users": len(self._states), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": self.hit_rate()}
