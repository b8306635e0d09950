"""Reading the profiler's trace of a few steady steps: device busy time as
the union of the device's operations, the traced window, device time by
kernel name, and the idle gaps named by what the host was running."""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def _union(iv: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


class Trace:
    """The events of one profiler window, in seconds."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in prof.events():
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.name.startswith("ProfilerStep"):
                continue                # a step's annotation, not an op
            if e.device_type == DeviceType.CUDA:
                self.device.append((s, t, e.name))
            elif e.device_type == DeviceType.CPU:
                self.host.append((s, t, e.name))
        every = [(s, t) for s, t, _ in self.device + self.host]
        self.t0 = min(s for s, _ in every) if every else 0.0
        self.t1 = max(t for _, t in every) if every else 0.0
        self.busy_iv = _union([(s, t) for s, t, _ in self.device])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_iv)

    def by_name(self) -> Dict[str, float]:
        """Device seconds by operation name (summed, not unioned)."""
        out: Dict[str, float] = defaultdict(float)
        for s, t, n in self.device:
            out[n] += t - s
        return dict(out)

    def matching(self, patterns, exclude=()) -> float:
        """Device seconds of operations whose name holds any pattern and
        none of ``exclude``."""
        return sum(t - s for s, t, n in self.device
                   if any(p in n for p in patterns)
                   and not any(x in n for x in exclude))

    def top_ops(self, k: int = 10) -> List[List]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], s] for n, s in ops]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time of the device between its operations (and at the
        window's ends), summed by the innermost (shortest) host operation
        running at each gap's middle; the k largest. One sweep over the
        gaps and the host operations in time order."""
        edges = [(self.t0, self.t0)] + self.busy_iv + [(self.t1, self.t1)]
        gaps = [(0.5 * (a + b), b - a) for (_, a), (b, _)
                in zip(edges, edges[1:]) if b > a]
        host = sorted(self.host)
        out: Dict[str, float] = defaultdict(float)
        live: List[Tuple[float, float, str]] = []     # (duration, end, name)
        j = 0
        for mid, length in gaps:
            while j < len(host) and host[j][0] <= mid:
                s, t, n = host[j]
                heapq.heappush(live, (t - s, t, n))
                j += 1
            while live and live[0][1] < mid:
                heapq.heappop(live)
            name = live[0][2] if live else "no host operation"
            out["host: " + name[:100]] += length
        return [[n, s] for n, s in sorted(out.items(),
                                         key=lambda kv: -kv[1])[:k]]
