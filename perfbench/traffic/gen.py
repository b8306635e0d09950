"""The one generator of every traffic mix, driven by the mix's JSON file.

Events follow the synthetic KuaiRand-27K surrogate of the program
(``repro_torch/data/synthetic.py``, copied here so that the yardstick
cannot move with the program): Zipf item popularity by inverse-transform
sampling, then a fixed multiplicative hash that scatters the popular ranks
over the id space; timestamps as an offset in the first week of a month
plus exponential gaps.

History lengths are lognormal(mu, sigma), but not drawn at random: a pack
of n users holds one user from each of n equal-probability strata, the
stratum's mean length (capped), so every pack and every seed has the same
multiset of lengths and the same work. The seed picks the order of the
users in a pack, their items and their timestamps.

Training mixes make whole packed batches (``train_batch``). Serving mixes
make the open-loop schedule (``arrivals``) and new users' histories.
"""
from __future__ import annotations

import functools
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

MONTH_S = 30 * 24 * 3600
HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> Dict:
    """The mix ``name`` from ``traffic/<name>.json``."""
    path = HERE / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    mix = json.loads(path.read_text())
    mix["name"] = name
    return mix


def rng_for(seed: int, *key: int) -> np.random.Generator:
    """A generator keyed by the run's seed and a position (step, slot):
    the same key gives the same numbers whatever was drawn before."""
    return np.random.default_rng([int(seed) % (1 << 64), *map(int, key)])


def strata_lengths(mu: float, sigma: float, cap: int, n: int,
                   points: int = 512) -> List[int]:
    """The mean of min(L, cap) over each of n equal-probability strata of
    L ~ lognormal(mu, sigma), rounded, at least 2 (a user needs two
    events for one training pair)."""
    return list(_strata_lengths(float(mu), float(sigma), int(cap), int(n),
                                int(points)))


@functools.lru_cache(maxsize=None)
def _strata_lengths(mu: float, sigma: float, cap: int, n: int,
                    points: int) -> Tuple[int, ...]:
    # n·points inverse normal CDFs in Python: computed once a run, not at
    # every batch, so the feed holds the interpreter lock as little as a
    # real loader's would
    nd = NormalDist()
    out = []
    for j in range(n):
        s = 0.0
        for i in range(points):
            p = (j + (i + 0.5) / points) / n
            s += min(float(cap), math.exp(mu + sigma * nd.inv_cdf(p)))
        out.append(max(2, int(round(s / points))))
    return tuple(out)


def zipf_items(rng: np.random.Generator, n: int, vocab: int,
               a: float) -> np.ndarray:
    """n item ids: Zipf(a) ranks by inversion, scattered by a fixed hash."""
    u = np.maximum(rng.random(n), 1e-12)
    ranks = np.minimum(u ** (-1.0 / (a - 1.0)) - 1.0, float(vocab - 1))
    return ((ranks.astype(np.int64) * 2654435761 + 12345) % vocab
            ).astype(np.int32)


def timestamps(rng: np.random.Generator, n: int) -> np.ndarray:
    t0 = rng.integers(0, MONTH_S // 4)
    gaps = rng.exponential(MONTH_S / (4 * max(n, 1)), n).astype(np.int64)
    return (t0 + np.cumsum(np.maximum(gaps, 1))).astype(np.int64)


def user_history(rng: np.random.Generator, n: int, vocab: int,
                 a: float) -> Tuple[np.ndarray, np.ndarray]:
    """(items int32, timestamps int64) of one user's n events."""
    return zipf_items(rng, n, vocab, a), timestamps(rng, n)


# --------------------------------------------------------------------------
# training: packed batches
# --------------------------------------------------------------------------

def pack_lengths(mix: Dict) -> List[int]:
    """The event counts of one pack's users (before the seed orders them):
    each history is cut to its last ``max_seq_len`` + 1 events, which give
    ``max_seq_len`` training pairs."""
    L = mix["lengths"]
    return strata_lengths(L["mu"], L["sigma"], mix["max_seq_len"] + 1,
                          mix["users_per_pack"])


def train_users(mix: Dict, seed: int, step: int, vocab: int
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The users of step ``step``: one per length stratum, in an order
    drawn from the seed and the step."""
    lens = pack_lengths(mix)
    order = rng_for(seed, step).permutation(len(lens))
    a = mix["items"]["zipf_a"]
    return [user_history(rng_for(seed, step, slot), lens[j], vocab, a)
            for slot, j in enumerate(order)]


def train_batch(mix: Dict, seed: int, step: int, vocab: int,
                num_negatives: int) -> Dict[str, np.ndarray]:
    """The packed (1, cap) batch of step ``step`` in the program's layout:
    users back to back, ids the events, labels the next events, timestamps
    from each user's first event, offsets (1, 2·users + 1) padded with the
    total, uniform negatives (1, cap, R) for every slot (padding too, as
    the program's loader draws them)."""
    users = train_users(mix, seed, step, vocab)
    cap = mix["users_per_pack"] * mix["max_seq_len"]
    ids = np.zeros((1, cap), np.int32)
    labels = np.zeros((1, cap), np.int32)
    ts = np.zeros((1, cap), np.int32)
    offsets = np.zeros((1, 2 * mix["users_per_pack"] + 1), np.int32)
    cur = 0
    for j, (it, tt) in enumerate(users):
        n = len(it) - 1
        ids[0, cur:cur + n] = it[:-1]
        labels[0, cur:cur + n] = it[1:]
        ts[0, cur:cur + n] = (tt[:-1] - tt[0]).astype(np.int32)
        cur += n
        offsets[0, j + 1] = cur
    offsets[0, len(users) + 1:] = cur
    r = rng_for(seed, step, 1 << 20)
    neg = r.integers(0, vocab, (1, cap, num_negatives), dtype=np.int32)
    key = r.integers(0, 1 << 31, (2,)).astype(np.uint32)
    return {"ids": ids, "labels": labels, "timestamps": ts,
            "offsets": offsets, "neg_ids": neg, "rng": key}


# --------------------------------------------------------------------------
# serving: the open loop
# --------------------------------------------------------------------------

def arrivals(mix: Dict, seed: int, seconds: float
             ) -> Tuple[np.ndarray, List[str], List[int]]:
    """The open loop at the mix's rate for ``seconds``: (arrival times
    from the window's start, kinds, new users' history lengths). Every
    seed gets the same work in another order: n = rate × seconds arrivals
    whose gaps are the n quantile midpoints of Exp(rate), the kinds in the
    mix's proportions, the new users' lengths one per stratum of the
    lognormal; the seed shuffles each."""
    rng = rng_for(seed, 1 << 21)
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    t = np.cumsum(rng.permutation(-np.log1p(-q) / rate))
    names = list(mix["kinds"])
    w = np.array([mix["kinds"][k] for k in names], np.float64)
    share = w / w.sum() * n
    counts = np.floor(share).astype(int)
    for j in np.argsort(-(share - counts))[:n - counts.sum()]:
        counts[j] += 1
    kinds = [names[j] for j in rng.permutation(np.repeat(np.arange(len(names)),
                                                         counts))]
    L = mix["lengths"]
    n_new = kinds.count("new")
    lens = strata_lengths(L["mu"], L["sigma"], mix["max_seq_len"], n_new,
                          points=64) if n_new else []
    return t, kinds, [lens[j] for j in rng.permutation(n_new)]


def warm_lengths(mix: Dict) -> List[int]:
    """The history lengths of the users resident before the window: one
    per stratum of the new users' length distribution."""
    L = mix["lengths"]
    return strata_lengths(L["mu"], L["sigma"], mix["max_seq_len"],
                          mix["resident_users"])
