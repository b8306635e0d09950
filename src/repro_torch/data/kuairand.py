"""KuaiRand-27K preprocessing (paper Appendix A): the port's copy of
``repro.data.kuairand``, numpy only.

Operates on a columnar interaction log (dict of 1-D numpy arrays with at
least user/item/ts plus feedback flags) — the format both the synthetic
surrogate and a real KuaiRand export produce:

  1. drop negative interactions — explicit dislike, or users with no
     positive signal (click/like/follow/comment/forward/long view);
  2. 5-core filtering (iterated until fixpoint): every user ≥5
     interactions, every item ≥5 distinct users;
  3. group by user, chronological sort;
  4. leave-one-out split: last item per user is the test ground truth.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

POSITIVE_SIGNALS = ("click", "like", "follow", "comment", "forward",
                    "long_view")


def drop_negative(log: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    keep = np.ones(len(log["user"]), bool)
    if "dislike" in log:
        keep &= ~log["dislike"].astype(bool)
    pos = np.zeros(len(log["user"]), bool)
    for s in POSITIVE_SIGNALS:
        if s in log:
            pos |= log[s].astype(bool)
    # users with no positive interaction at all are dropped entirely
    pos_users = np.unique(log["user"][pos])
    keep &= np.isin(log["user"], pos_users)
    return {k: v[keep] for k, v in log.items()}


def five_core_filter(log: Dict[str, np.ndarray], k: int = 5,
                     max_iters: int = 20) -> Dict[str, np.ndarray]:
    """Iterate user≥k / item≥k filtering to a fixpoint."""
    for _ in range(max_iters):
        n0 = len(log["user"])
        u, cu = np.unique(log["user"], return_counts=True)
        keep_u = set(u[cu >= k].tolist())
        mask = np.fromiter((x in keep_u for x in log["user"]), bool,
                           len(log["user"]))
        log = {kk: v[mask] for kk, v in log.items()}
        it, ci = np.unique(log["item"], return_counts=True)
        keep_i = set(it[ci >= k].tolist())
        mask = np.fromiter((x in keep_i for x in log["item"]), bool,
                           len(log["item"]))
        log = {kk: v[mask] for kk, v in log.items()}
        if len(log["user"]) == n0:
            break
    return log


def group_sequences(log: Dict[str, np.ndarray]
                    ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """user → (items chronological, timestamps)."""
    order = np.lexsort((log["ts"], log["user"]))
    users = log["user"][order]
    items = log["item"][order]
    ts = log["ts"][order]
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    bounds = np.flatnonzero(np.diff(users)) + 1
    for lo, hi in zip(np.concatenate([[0], bounds]),
                      np.concatenate([bounds, [len(users)]])):
        out[int(users[lo])] = (items[lo:hi], ts[lo:hi])
    return out


def leave_one_out(seqs: Dict[int, Tuple[np.ndarray, np.ndarray]]):
    """(train sequences, test ground-truth item per user)."""
    train, test = {}, {}
    for u, (it, ts) in seqs.items():
        if len(it) < 2:
            continue
        train[u] = (it[:-1], ts[:-1])
        test[u] = int(it[-1])
    return train, test


def preprocess_log(log: Dict[str, np.ndarray], k_core: int = 5):
    """Full Appendix-A pipeline: returns (train seqs, test dict, item remap).

    Item ids are remapped to a dense [0, n_items) space (the embedding-table
    row space)."""
    log = drop_negative(log)
    log = five_core_filter(log, k_core)
    items = np.unique(log["item"])
    remap = {int(x): i for i, x in enumerate(items)}
    log["item"] = np.fromiter((remap[int(x)] for x in log["item"]),
                              np.int64, len(log["item"]))
    seqs = group_sequences(log)
    train, test = leave_one_out(seqs)
    return train, test, remap
