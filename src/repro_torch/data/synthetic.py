"""Synthetic KuaiRand-27K surrogate (the port's copy of
``repro.data.synthetic.SyntheticKuaiRand``, numpy only).

The real dataset is not redistributable here; this generator produces a
statistically matched interaction log: 27k users, zipf(1.1) item
popularity over a multi-million item space, long-tail (lognormal) per-user
sequence lengths, monotone per-user timestamps over a one-month window, and
multi-signal feedback (click/like/follow/long-view + an explicit dislike
channel), as the reference's generator does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device

MONTH_S = 30 * 24 * 3600


@dataclass
class SyntheticKuaiRand:
    num_users: int = 27_000
    num_items: int = 4_000_000
    mean_len: float = 120.0       # lognormal mean sequence length
    sigma_len: float = 1.0
    max_len: int = 8_192
    zipf_a: float = 1.1
    dislike_rate: float = 0.03
    seed: int = 0

    def user_lengths(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        mu = np.log(self.mean_len) - self.sigma_len ** 2 / 2
        ln = rng.lognormal(mu, self.sigma_len, self.num_users)
        return np.clip(ln.astype(np.int64), 2, self.max_len)

    def _items(self, rng, n: int) -> np.ndarray:
        """Zipf-ish popularity: rank sampled via u^(1/(1-a)) inversion,
        then a fixed permutation so popular ids are scattered."""
        u = np.maximum(rng.random(n), 1e-12)
        ranks_f = np.minimum(u ** (-1.0 / (self.zipf_a - 1.0)) - 1.0,
                             float(self.num_items - 1))
        ranks = ranks_f.astype(np.int64)
        # cheap stateless scatter of ranks -> ids
        return (ranks * 2654435761 + 12345) % self.num_items

    def interactions(self, user: int) -> Dict[str, np.ndarray]:
        """One user's chronological log with feedback signals."""
        rng = np.random.default_rng(self.seed * 1_000_003 + user)
        n = int(self.user_lengths()[user])
        items = self._items(rng, n)
        t0 = rng.integers(0, MONTH_S // 4)
        gaps = rng.exponential(MONTH_S / (4 * max(n, 1)), n).astype(np.int64)
        ts = t0 + np.cumsum(np.maximum(gaps, 1))
        click = rng.random(n) < 0.45
        like = rng.random(n) < 0.08
        follow = rng.random(n) < 0.01
        long_view = rng.random(n) < 0.30
        dislike = rng.random(n) < self.dislike_rate
        return {"user": np.full(n, user, np.int64), "item": items,
                "ts": ts, "click": click, "like": like, "follow": follow,
                "long_view": long_view, "dislike": dislike}

    def log(self, users: int = 0) -> Dict[str, np.ndarray]:
        """Concatenated interaction log for the first ``users`` users."""
        users = users or self.num_users
        parts = [self.interactions(u) for u in range(users)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def synth_jagged_batch(generator: Optional[torch.Generator], num_shards: int,
                       capacity: int, vocab: int, num_negatives: int,
                       offsets=None, device: DeviceLike = None
                       ) -> Dict[str, torch.Tensor]:
    """A random (G, cap) jagged GR training batch made where it is used:
    on the card unless ``device="cpu"``, its numbers from ``generator``
    (which must live on that device; vary it per step for a data stream).
    The reference draws from a jax key, so the numbers differ; the fields,
    ranges and layout are its: ids in [0, V), labels in [1, V), timestamps
    the running sum of steps in [0, 60), negatives in [0, V), ``rng`` zeros.
    ``offsets`` defaults to two equal samples per shard; pass a (G, S+1)
    array for ragged layouts."""
    dev = resolve_device(device)
    G, cap = num_shards, capacity
    if offsets is None:
        offsets = torch.tensor([0, cap // 2, cap], dtype=torch.int32,
                               device=dev).repeat(G, 1)
    else:
        offsets = torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                                  device=dev)

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev,
                             dtype=torch.int32)

    return {
        "ids": draw(0, vocab, (G, cap)),
        "labels": draw(1, vocab, (G, cap)),
        "timestamps": torch.cumsum(draw(0, 60, (G, cap)), 1,
                                   dtype=torch.int32),
        "offsets": offsets,
        "neg_ids": draw(0, vocab, (G, cap, num_negatives)),
        "rng": torch.zeros((2,), dtype=torch.int64, device=dev),
    }
