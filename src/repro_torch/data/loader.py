"""GR data loader: user sequences → per-device jagged training batches
(the port's copy of ``repro.data.loader``, numpy only).

Integrates §4.1.3 load balancing: ``strategy`` picks fixed batches
(baseline), token-aware dynamic batch scaling (short sequences) or global
token reallocation (long sequences). Emits the (G, cap, …) batch dict the
GR bundle consumes, plus per-device sample-count weights for the weighted
gradient aggregation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.core import load_balance as LB


@dataclass
class GRLoader:
    sequences: Dict[int, Tuple[np.ndarray, np.ndarray]]  # user -> (items, ts)
    num_devices: int
    users_per_device: int
    max_seq_len: int
    num_negatives: int
    num_items: int
    strategy: str = "token_realloc"   # fixed | token_scaling | token_realloc
    seed: int = 0

    def __post_init__(self):
        self.users = sorted(self.sequences)
        self.rng = np.random.default_rng(self.seed)
        self.capacity = self.users_per_device * self.max_seq_len
        self.max_samples = 2 * self.users_per_device

    def _assign(self, batch_users: List[int]) -> List[List[int]]:
        lengths = [min(len(self.sequences[u][0]), self.max_seq_len)
                   for u in batch_users]
        if self.strategy == "fixed":
            a = LB.fixed_batches(lengths, self.num_devices,
                                 self.users_per_device)
        elif self.strategy == "token_scaling":
            budget = int(np.ceil(sum(lengths) / self.num_devices))
            a = LB.token_aware_batches(lengths, self.num_devices, budget)
        else:
            a = LB.global_token_reallocation(lengths, self.num_devices)
        return a

    def batches(self, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        per_step = self.num_devices * self.users_per_device
        order = self.rng.permutation(self.users)
        pos = 0
        for _ in range(steps):
            if pos + per_step > len(order):
                order = self.rng.permutation(self.users)
                pos = 0
            batch_users = [int(u) for u in order[pos:pos + per_step]]
            pos += per_step
            yield self.make_batch(batch_users)

    def make_batch(self, batch_users: List[int]) -> Dict[str, np.ndarray]:
        G, cap = self.num_devices, self.capacity
        # single-event users yield zero next-item pairs; drop them BEFORE
        # assignment so the per-device balance, the ≥1-sample clamp, and
        # the sample-count gradient weights all see the rows that are
        # actually packed (a post-assignment drop could leave an all-pad
        # device with nonzero weight)
        batch_users = [u for u in batch_users
                       if len(self.sequences[u][0]) >= 2]
        assign = self._assign(batch_users)
        ids = np.zeros((G, cap), np.int32)
        labels = np.zeros((G, cap), np.int32)
        ts = np.zeros((G, cap), np.int32)
        offsets = np.zeros((G, self.max_samples + 1), np.int32)
        for g, rows in enumerate(assign):
            cur = 0
            nseq = 0
            for r in rows:
                u = batch_users[r]
                it, tt = self.sequences[u]
                it = it[-(self.max_seq_len + 1):]
                tt = tt[-(self.max_seq_len + 1):]
                n = len(it) - 1           # next-item training pairs
                if n <= 0 or cur + n > cap or nseq >= self.max_samples:
                    continue
                ids[g, cur:cur + n] = it[:-1]
                labels[g, cur:cur + n] = it[1:]
                ts[g, cur:cur + n] = (tt[:-1] - tt[0]).astype(np.int32)
                cur += n
                nseq += 1
                offsets[g, nseq] = cur
            offsets[g, nseq + 1:] = cur   # pad offsets repeat the total
        neg = self.rng.integers(0, self.num_items,
                                (G, cap, self.num_negatives), dtype=np.int32)
        weights = LB.sample_count_weights(assign)
        return {"ids": ids, "labels": labels, "timestamps": ts,
                "offsets": offsets, "neg_ids": neg,
                "rng": self.rng.integers(0, 2 ** 31, (2,)).astype(np.uint32),
                "weights": weights.astype(np.float32)}
