"""Dynamic jagged load balancing (paper §4.1.3), host-side numpy.

The parts the serving scheduler and the training loader use: Global Token
Reallocation (an LPT greedy that spreads sequences over devices without
splitting any), fixed and token-aware batches, the sample-count
gradient weights of dynamic batch sizes, and Table 3's two statistics: the
load-imbalance ratio that the telemetry's ``token_imbalance`` reports and
the max token-count difference across devices.
"""
from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np


def global_token_reallocation(lengths: Sequence[int],
                              num_devices: int) -> List[List[int]]:
    """Sort samples by token count descending and repeatedly assign each to
    the least-loaded device (min-heap); arrival order is restored within a
    device."""
    order = np.argsort(-np.asarray(lengths, np.int64), kind="stable")
    heap: List[Tuple[int, int]] = [(0, w) for w in range(num_devices)]
    heapq.heapify(heap)
    out: List[List[int]] = [[] for _ in range(num_devices)]
    for i in order:
        load, w = heapq.heappop(heap)
        out[w].append(int(i))
        heapq.heappush(heap, (load + int(lengths[i]), w))
    for a in out:
        a.sort()
    return out


def fixed_batches(lengths: Sequence[int], num_devices: int,
                  per_device: int) -> List[List[int]]:
    """Baseline: fixed sample count per device, arrival order."""
    out = []
    for w in range(num_devices):
        lo = w * per_device
        out.append(list(range(lo, min(lo + per_device, len(lengths)))))
    return out


def token_aware_batches(lengths: Sequence[int], num_devices: int,
                        token_budget: int) -> List[List[int]]:
    """§4.1.3 Token-Aware Dynamic Batch Scaling.

    Stream samples in arrival order; a device keeps accepting samples until
    its token budget is met, then the next device fills. Every device ends
    within one sample of the budget; sample counts differ (the weighted
    gradient aggregation compensates).
    """
    out: List[List[int]] = [[] for _ in range(num_devices)]
    loads = [0] * num_devices
    w = 0
    for i, ln in enumerate(lengths):
        if (loads[w] + ln > token_budget and loads[w] > 0
                and w < num_devices - 1):
            w += 1
        out[w].append(i)
        loads[w] += int(ln)
    # Edge case: one over-budget sequence can eat a whole device's budget
    # and leave trailing devices empty (an empty per-device jagged batch
    # breaks SPMD callers that assume ≥1 sample everywhere). Clamp by
    # draining the tail of the most-loaded multi-sample device into each
    # empty one — the partition property is preserved; only the tail
    # absorber's arrival-order contiguity is relaxed.
    if len(lengths) >= num_devices:
        for w in range(num_devices):
            if out[w]:
                continue
            donor = max(range(num_devices),
                        key=lambda d: (len(out[d]) > 1, loads[d]))
            if len(out[donor]) <= 1:
                break               # nothing movable (shouldn't happen)
            moved = out[donor].pop()
            loads[donor] -= int(lengths[moved])
            out[w].append(moved)
            loads[w] += int(lengths[moved])
    return out


def sample_count_weights(assignments: Sequence[Sequence[int]]) -> np.ndarray:
    """Per-device gradient weights for dynamic batch sizes: w_i = n_i / Σn.

    With per-device mean-loss gradients g_i, the correctly aggregated
    gradient is Σ w_i·g_i — identical to the global-mean gradient a fixed
    batch would produce (tested in tests/test_load_balance.py).
    """
    counts = np.array([len(a) for a in assignments], np.float64)
    return counts / max(counts.sum(), 1.0)


def assignment_token_loads(assignments: Sequence[Sequence[int]],
                           lengths: Sequence[int]) -> np.ndarray:
    """Per-device token loads ``tokens_w = Σ_{i∈a_w} lengths[i]``."""
    lens = np.asarray(lengths, np.int64)
    return np.array([lens[np.asarray(a, np.int64)].sum() if len(a) else 0
                     for a in assignments], np.int64)


def max_token_diff(assignments: Sequence[Sequence[int]],
                   lengths: Sequence[int],
                   loads: np.ndarray = None) -> int:
    """Table 3's metric: max_w(tokens_w) − min_w(tokens_w). ``loads`` (from
    :func:`assignment_token_loads`) short-circuits the per-device
    summation."""
    if loads is None:
        loads = assignment_token_loads(assignments, lengths)
    return int(np.max(loads) - np.min(loads))


def imbalance_ratio(assignments: Sequence[Sequence[int]],
                    lengths: Sequence[int],
                    step_cost_per_token: float = 1.0,
                    fixed_overhead: float = 0.0,
                    loads: np.ndarray = None) -> float:
    """Load-imbalance delay ratio (Table 3 column 4): idle time of the
    average worker relative to the makespan, under a linear cost model
    cost_w = overhead + tokens_w · c. ``loads`` (per-device token loads)
    short-circuits the per-device summation."""
    if loads is None:
        loads = assignment_token_loads(assignments, lengths)
    costs = fixed_overhead + step_cost_per_token * np.asarray(loads,
                                                             np.float64)
    makespan = costs.max()
    if makespan <= 0:
        return 0.0
    return float((makespan - costs.mean()) / makespan)
