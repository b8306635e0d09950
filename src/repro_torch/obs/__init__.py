"""Observability: span tracing + metrics registry + derived gauges (the
port's copy of ``repro.obs``).

``Obs`` is the one handle the engines take (``GREngine(obs=...)``,
``RecallEngine(obs=...)``, ``StreamingRecallEngine(obs=...)``): a tracer
(Perfetto-exportable spans) plus a ``MetricsRegistry`` (counters, gauges
and histograms with one ``snapshot()``). ``Obs.noop()`` builds a disabled
instance whose recording paths are constant-time no-ops, so instrumented
code can be written unconditionally. Nothing here synchronises the card:
spans and step walls are the host's clock.

    obs = Obs()
    engine = GREngine(bundle, data, obs=obs, ...)
    engine.run(steps)
    obs.export_trace("trace.json")      # open in ui.perfetto.dev
    print(obs.to_prometheus())
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.obs.derived import (PEAK_FLOPS, gr_dense_params,
                                     measured_mfu, peak_flops_of,
                                     pipeline_goodput, token_imbalance)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.trace import (NULL_SPAN, Span, Tracer,
                                   busy_from_intervals, trace_busy_by_track)

__all__ = [
    "Obs",
    "Tracer",
    "Span",
    "NULL_SPAN",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_BUCKETS",
    "PEAK_FLOPS",
    "gr_dense_params",
    "measured_mfu",
    "peak_flops_of",
    "token_imbalance",
    "pipeline_goodput",
    "busy_from_intervals",
    "trace_busy_by_track",
]


class Obs:
    """Facade bundling one tracer + one metrics registry."""

    def __init__(self, enabled: bool = True,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None) -> None:
        self.enabled = enabled
        self.tracer = tracer if tracer is not None else Tracer(enabled=enabled)
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    @classmethod
    def noop(cls) -> "Obs":
        return cls(enabled=False)

    # thin pass-throughs so call sites don't reach two levels deep
    def span(self, name: str, track: Optional[str] = None, **args: Any):
        return self.tracer.span(name, track, **args)

    def snapshot(self) -> Dict[str, Any]:
        return self.metrics.snapshot()

    def to_prometheus(self) -> str:
        return self.metrics.to_prometheus()

    def export_trace(self, path: str,
                     process_name: str = "repro_torch") -> Dict[str, Any]:
        return self.tracer.export(path, process_name)
