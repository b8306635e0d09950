"""Dynamic jagged load balancing (paper §4.1.3), host-side numpy.

Only the part the serving scheduler uses: Global Token Reallocation, an
LPT greedy that spreads sequences over devices without splitting any.
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
