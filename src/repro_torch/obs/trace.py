"""Span tracer with Chrome/Perfetto ``trace_event`` export (the port's copy
of ``repro.obs.trace``).

The tracer is deliberately dumb: a thread-safe append-only list of
closed ``Span`` records on a monotonic clock.  Everything clever —
per-track busy-time union, goodput ratios, the Chrome JSON layout —
is computed at export/report time from the immutable span list, so
recording stays cheap enough to leave on during benchmarks.

Clocks: spans carry ``time.perf_counter()`` timestamps (seconds,
monotonic, same clock as ``core/pipeline.StageEvent``), so spans
recorded live and spans ingested from a ``SixStagePipeline`` event
stream land on a common timeline.  Tests inject explicit ``now=``
values instead of patching the clock.  Spans time the host's clock: on the
card a stage that enqueues kernels and does not wait for them lasts as long
as its launches, not as its device work.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.pipeline import REPORT_MERGED, StageEvent

__all__ = [
    "Span",
    "Tracer",
    "NULL_SPAN",
    "busy_from_intervals",
    "trace_busy_by_track",
]


@dataclass(frozen=True)
class Span:
    """One closed interval on a named track.

    ``track`` groups spans into horizontal rows in the Perfetto UI (one
    per pipeline stage / worker thread); ``name`` labels the individual
    slice.  ``start``/``end`` are ``perf_counter`` seconds.
    """

    name: str
    track: str
    start: float
    end: float
    args: Mapping[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.end - self.start


class _NullSpanCtx:
    """Shared no-op context manager handed out by a disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpanCtx":
        return self

    def __exit__(self, *exc: object) -> None:
        return None


_NULL_SPAN = _NullSpanCtx()
#: shared no-op span context for call sites instrumenting optionally
NULL_SPAN = _NULL_SPAN


def busy_from_intervals(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total covered time of a set of (start, end) intervals (union)."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    busy = 0.0
    cur_s: Optional[float] = None
    cur_e = 0.0
    for s, e in ivs:
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
    if cur_s is not None:
        busy += cur_e - cur_s
    return busy


class Tracer:
    """Thread-safe span recorder.

    ``enabled=False`` makes every recording entry point a constant-time
    no-op (``span()`` returns one shared null context manager; nothing
    allocates), which is what ``Obs.noop()`` relies on for the
    zero-overhead acceptance criterion.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._instants: List[Tuple[str, str, float, Mapping[str, Any]]] = []

    # ---- recording ---------------------------------------------------
    @contextmanager
    def _span_cm(self, name: str, track: str, args: Optional[Mapping[str, Any]]):
        start = self.clock()
        try:
            yield self
        finally:
            end = self.clock()
            with self._lock:
                self._spans.append(Span(name, track, start, end, args or {}))

    def span(self, name: str, track: Optional[str] = None,
             **args: Any):
        """Context manager recording one span; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return self._span_cm(name, track or name, args or None)

    def record(self, name: str, track: str, start: float, end: float,
               args: Optional[Mapping[str, Any]] = None) -> None:
        """Record a span with explicit timestamps (``now=`` injection)."""
        if not self.enabled:
            return
        with self._lock:
            self._spans.append(Span(name, track, start, end, args or {}))

    def instant(self, name: str, track: str = "events",
                now: Optional[float] = None,
                args: Optional[Mapping[str, Any]] = None) -> None:
        """Record a zero-duration marker (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        ts = self.clock() if now is None else now
        with self._lock:
            self._instants.append((name, track, ts, args or {}))

    # ---- adapters ----------------------------------------------------
    def ingest_stage_events(self, events: Sequence[StageEvent],
                            records: Optional[Mapping[int, Mapping[str, Any]]] = None,
                            merge: Mapping[str, str] = REPORT_MERGED) -> int:
        """Ingest a ``SixStagePipeline`` event stream as spans.

        One track per (merged) stage name, matching ``timeline_report``'s
        ``stage_s`` accounting so exported busy times can be compared
        against it directly.  ``records`` (step -> per-step record dict)
        decorates each span's args with step/tokens/loss/cache hit rate.
        """
        if not self.enabled:
            return 0
        n = 0
        for ev in events:
            track = merge.get(ev.stage, ev.stage)
            args: Dict[str, Any] = {"stage": ev.stage, "step": ev.batch}
            rec = records.get(ev.batch) if records else None
            if rec is not None:
                for k in ("tokens", "loss", "step_wall_s", "mfu", "imbalance"):
                    if k in rec:
                        args[k] = rec[k]
                cache = rec.get("cache")
                if isinstance(cache, Mapping) and "hit_rate" in cache:
                    args["cache_hit_rate"] = cache["hit_rate"]
            self.record(ev.stage, track, ev.start, ev.end, args)
            n += 1
        return n

    def ingest_recovery_events(self, events: Sequence[Any],
                               t0: float = 0.0) -> int:
        """Ingest resilience ``RecoveryEvent``s as spans on a "recovery"
        track.

        ``RecoveryEvent`` carries only durations (``wall_s``), so spans
        are laid end-to-end from ``t0`` — a post-hoc view, not a real
        timeline.  ``GREngine.run_resilient`` records recovery spans
        live with real timestamps instead; this adapter covers event
        lists captured elsewhere.
        """
        if not self.enabled:
            return 0
        t = t0
        n = 0
        for ev in events:
            wall = float(getattr(ev, "wall_s", 0.0))
            self.record("recovery", "recovery", t, t + wall, {
                "failed_step": getattr(ev, "failed_step", None),
                "restored_step": getattr(ev, "restored_step", None),
                "steps_lost": getattr(ev, "steps_lost", None),
                "error": str(getattr(ev, "error", "")),
            })
            t += wall
            n += 1
        return n

    # ---- views -------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._instants.clear()

    def busy_by_track(self) -> Dict[str, float]:
        """Per-track busy seconds (interval union of that track's spans)."""
        by_track: Dict[str, List[Tuple[float, float]]] = {}
        for sp in self.spans():
            by_track.setdefault(sp.track, []).append((sp.start, sp.end))
        return {t: busy_from_intervals(ivs) for t, ivs in sorted(by_track.items())}

    def wall_span(self) -> Tuple[float, float]:
        """(min start, max end) over all spans; (0, 0) when empty."""
        spans = self.spans()
        if not spans:
            return (0.0, 0.0)
        return (min(s.start for s in spans), max(s.end for s in spans))

    # ---- export ------------------------------------------------------
    def to_chrome_trace(self, process_name: str = "repro") -> Dict[str, Any]:
        """Chrome/Perfetto ``trace_event`` JSON object.

        One thread (track) per pipeline stage / worker, named via ``M``
        metadata events; spans become ``X`` complete events with float-µs
        timestamps so round-tripped busy times match to <1 ns.
        """
        with self._lock:
            spans = list(self._spans)
            instants = list(self._instants)
        tracks = sorted({s.track for s in spans} | {t for _, t, _, _ in instants})
        tid_of = {t: i + 1 for i, t in enumerate(tracks)}
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": process_name},
        }]
        for track, tid in tid_of.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": track}})
        for sp in spans:
            events.append({
                "name": sp.name, "ph": "X", "pid": 1, "tid": tid_of[sp.track],
                "ts": sp.start * 1e6, "dur": sp.dur * 1e6,
                "cat": sp.track, "args": dict(sp.args),
            })
        for name, track, ts, args in instants:
            events.append({"name": name, "ph": "i", "pid": 1,
                           "tid": tid_of[track], "ts": ts * 1e6, "s": "t",
                           "args": dict(args)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str, process_name: str = "repro") -> Dict[str, Any]:
        trace = self.to_chrome_trace(process_name)
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


def trace_busy_by_track(trace: Mapping[str, Any]) -> Dict[str, float]:
    """Per-track busy seconds recomputed from an exported Chrome trace.

    Used by tests/benchmarks to verify the exported JSON — not the
    in-memory tracer — agrees with ``timeline_report``'s ``stage_s``.
    """
    names: Dict[Tuple[int, int], str] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    ivs: Dict[str, List[Tuple[float, float]]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        track = names.get((ev["pid"], ev["tid"]), str(ev["tid"]))
        start = ev["ts"] / 1e6
        ivs.setdefault(track, []).append((start, start + ev["dur"] / 1e6))
    return {t: busy_from_intervals(v) for t, v in sorted(ivs.items())}
