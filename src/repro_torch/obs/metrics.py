"""Labeled counters / gauges / histograms with one ``snapshot()`` (the
port's copy of ``repro.obs.metrics``).

A deliberately small Prometheus-shaped registry: metric families are
created once (``registry.counter("train_steps_total", "...")``) and
instruments are fetched per label-set.  ``snapshot()`` returns one
nested dict with a stable, sorted key set; ``to_prometheus()`` renders
the standard text exposition format.

Existing stats surfaces (``latency_stats``, ``SequenceBuffer.stats``,
``CacheStats`` …) keep their dict return values — engines publish those
dicts into a registry via ``publish()``, which flattens numeric leaves
into gauges under a subsystem prefix.  Naming convention:
``<subsystem>_<name>[_unit]`` with ``train_``/``serve_``/``cache_``/
``ckpt_`` prefixes, ``_s`` for second-durations, ``_total`` for
counters.
"""
from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS"]

# log-spaced second buckets: 100µs .. 30s, good for step/tick/ckpt times
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, Any]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotonically increasing count for one label-set."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins value for one label-set."""

    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram for one label-set."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, cnt = self._sum, self._count
        cum = 0
        buckets: Dict[str, int] = {}
        for le, c in zip(self.buckets, counts):
            cum += c
            buckets[repr(le)] = cum
        buckets["+Inf"] = cum + counts[-1]
        return {"count": cnt, "sum": total,
                "mean": (total / cnt) if cnt else 0.0, "buckets": buckets}

    @property
    def count(self) -> int:
        return self._count


class _Family:
    __slots__ = ("name", "help", "kind", "buckets", "series", "_lock")

    def __init__(self, name: str, help: str, kind: str,
                 buckets: Optional[Sequence[float]] = None) -> None:
        self.name = name
        self.help = help
        self.kind = kind
        self.buckets = buckets
        self.series: Dict[LabelKey, Any] = {}
        self._lock = threading.Lock()

    def get(self, labels: Optional[Mapping[str, Any]]) -> Any:
        key = _label_key(labels)
        inst = self.series.get(key)
        if inst is None:
            with self._lock:
                inst = self.series.get(key)
                if inst is None:
                    if self.kind == "counter":
                        inst = Counter()
                    elif self.kind == "gauge":
                        inst = Gauge()
                    else:
                        inst = Histogram(self.buckets or DEFAULT_BUCKETS)
                    self.series[key] = inst
        return inst


class MetricsRegistry:
    """Thread-safe registry of metric families."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, help: str, kind: str,
                buckets: Optional[Sequence[float]] = None) -> _Family:
        name = sanitize_name(name)
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, help, kind, buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, not {kind}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, Any]] = None) -> Counter:
        return self._family(name, help, "counter").get(labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, Any]] = None) -> Gauge:
        return self._family(name, help, "gauge").get(labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, Any]] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._family(name, help, "histogram", buckets).get(labels)

    # ---- bulk ingestion ---------------------------------------------
    def publish(self, prefix: str, stats: Mapping[str, Any],
                labels: Optional[Mapping[str, Any]] = None) -> int:
        """Flatten a nested stats dict into gauges under ``prefix``.

        Numeric leaves become ``<prefix>_<dotted_path>`` gauges; bools
        publish as 0/1; strings and other non-numeric leaves are
        skipped.  Returns the number of gauges written.  This is how
        existing ``stats()`` dicts are mirrored into the registry
        without changing their return values.
        """
        n = 0
        for path, value in _flatten(stats):
            if isinstance(value, bool):
                value = float(value)
            elif not isinstance(value, (int, float)):
                continue
            name = sanitize_name(f"{prefix}_{path}")
            self.gauge(name, labels=labels).set(float(value))
            n += 1
        return n

    # ---- views -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Nested dict of every family, sorted by name; stable key set."""
        with self._lock:
            fams = sorted(self._families.items())
        out: Dict[str, Any] = {}
        for name, fam in fams:
            values: Dict[str, Any] = {}
            for key in sorted(fam.series):
                inst = fam.series[key]
                label = _label_str(key)
                if fam.kind == "histogram":
                    values[label] = inst.snapshot()
                else:
                    values[label] = inst.value
            out[name] = {"type": fam.kind, "help": fam.help, "values": values}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            fams = sorted(self._families.items())
        lines: List[str] = []
        for name, fam in fams:
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.series):
                inst = fam.series[key]
                lbl = "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}" if key else ""
                if fam.kind == "histogram":
                    snap = inst.snapshot()
                    for le, cum in snap["buckets"].items():
                        parts = [f'{k}="{v}"' for k, v in key] + [f'le="{le}"']
                        lines.append(f"{name}_bucket{{{','.join(parts)}}} {cum}")
                    lines.append(f"{name}_sum{lbl} {snap['sum']}")
                    lines.append(f"{name}_count{lbl} {snap['count']}")
                else:
                    lines.append(f"{name}{lbl} {inst.value}")
        return "\n".join(lines) + "\n"


def _flatten(stats: Mapping[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    for k in stats:
        v = stats[k]
        path = f"{prefix}_{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.extend(_flatten(v, path))
        else:
            out.append((path, v))
    return out
