"""Per-shape-regime knob store and tuner for the port's kernels (the port of
``repro.kernels.autotune``).

A knob is a launch setting that changes how fast a kernel runs and never
what it returns: a tuned value gives the same bits as the default. Two
meet that contract:

* ``neg_logits_fwd.row_split`` — K9-fwd's CTAs per token
  (``kernels/neg_logits/ops.py`` ``fwd_row_split``, the default): a split
  changes which CTA sums a logit, never how;
* ``neg_fused.scatter_impl`` — the form the fused path hands its negative
  table gradient on in: ``"fused"`` (K5 over the factored rows, the
  default) or ``"two_pass"`` (the rows built, then K6); the two give the
  same bits.

This module owns everything around picking their values:

* **candidate enumeration** from the knobs' validity rules
  (:func:`enumerate_candidates`);
* **measured sweeps** (:func:`measure`/:func:`sweep`): on the card each
  call is timed alone by CUDA events, recorded as spans on an ``obs``
  ``Tracer`` (track ``"autotune"``), the results published into a
  ``MetricsRegistry``; every valid candidate is measured (the port's cost
  model is the bounds ``chip_smoke.py`` computes; there is no second one);
* a **persistent store** (``tuned.json`` beside this file, keyed
  ``kernel|shape-bucket|backend``, the backend ``cuda-sm90`` on the H100
  and ``cpu`` on the CPU) that the wrappers consult through
  :func:`resolve`: a missing, corrupt or stale entry gives the default.
  ``resolve`` picks a knob's value and nothing else: never the plain
  version, never another device. Its answers are memoised per process
  (a wrapper consults it at every launch, and a launch of K9-fwd on a
  128-token segment takes ~15 µs on the card): :meth:`TunedStore.save`
  and :func:`clear_cache` drop them, so a store rewritten by another
  process is read after ``clear_cache()`` or in a new process.

Shape keys are buckets: extents above 256 round up to a power of two, so
one sweep covers a regime; small ones (R, segment, D) stay exact, since
validity depends on them. ``REPRO_TORCH_TUNED_JSON`` names another store
(the tests point it at a temporary file); the reference's ``tuned.json``
and ``REPRO_TUNED_JSON`` are never read.
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "DEFAULTS", "CANDIDATES", "shape_bucket", "knob_valid",
    "enumerate_candidates", "TunedStore", "default_path", "backend_of",
    "default_backend", "resolve", "clear_cache", "measure", "sweep",
]

ENV = "REPRO_TORCH_TUNED_JSON"
#: a sleep kernel queued before each timed call on the card, longer than
#: the host takes to enqueue the call (cycles, ~0.1 ms at 1.98 GHz)
FENCE_CYCLES = 200_000

# ---------------------------------------------------------------------------
# knob spaces
# ---------------------------------------------------------------------------

DEFAULTS: Dict[str, Dict[str, Any]] = {
    # the fused negative path (kernels/neg_logits/ops.py fused_recall_lse)
    "neg_fused": {"scatter_impl": "fused"},
    # K9-fwd; None: the wrapper's heuristic fwd_row_split(T, R), which it
    # passes to resolve as the default
    "neg_logits_fwd": {"row_split": None},
}

CANDIDATES: Dict[str, Dict[str, Tuple[Any, ...]]] = {
    "neg_fused": {"scatter_impl": ("fused", "two_pass")},
    "neg_logits_fwd": {"row_split": (1, 2, 4, 8)},
}


def shape_bucket(dims: Mapping[str, Any]) -> str:
    """Canonical bucket key for a dims dict: extents > 256 round up to a
    power of two, small ones stay exact, other values pass through."""
    parts = []
    for k in sorted(dims):
        v = dims[k]
        if isinstance(v, bool) or not isinstance(v, int):
            parts.append(f"{k}={v}")
        elif v > 256:
            parts.append(f"{k}=2^{max(v - 1, 1).bit_length()}")
        else:
            parts.append(f"{k}={v}")
    return ",".join(parts)


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def knob_valid(kernel: str, dims: Mapping[str, Any], knob: str,
               value: Any) -> bool:
    """Is ``value`` a legal setting of ``knob`` for these dims? ``resolve``
    checks every stored value against the current dims with it, so a
    store written for other shapes never configures a launch it cannot
    make."""
    if kernel == "neg_fused" and knob == "scatter_impl":
        return value in ("fused", "two_pass")
    if kernel == "neg_logits_fwd" and knob == "row_split":
        # each CTA keeps at least NL_FWD_MIN_ROWS of the token's rows
        from repro_torch.kernels.neg_logits.ops import NL_FWD_MIN_ROWS
        R = int(dims.get("R", 1))
        return _is_int(value) and (value == 1 or
                                   1 < value and value * NL_FWD_MIN_ROWS <= R)
    return False


def enumerate_candidates(kernel: str,
                         dims: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Every valid knob combination of the kernel at these dims."""
    space = CANDIDATES.get(kernel, {})
    knobs = sorted(space)
    out = [dict(zip(knobs, combo))
           for combo in itertools.product(*(space[k] for k in knobs))]
    return [c for c in out
            if all(knob_valid(kernel, dims, k, v) for k, v in c.items())]


# ---------------------------------------------------------------------------
# backend key
# ---------------------------------------------------------------------------

_BACKENDS: Dict[torch.device, str] = {}


def backend_of(device: Any) -> str:
    """``cuda-sm<major><minor>`` for a card (``cuda-sm90`` on the H100),
    ``cpu`` for the CPU."""
    dev = torch.device(device)
    key = _BACKENDS.get(dev)
    if key is None:
        if dev.type == "cuda":
            major, minor = torch.cuda.get_device_capability(dev)
            key = f"cuda-sm{major}{minor}"
        else:
            key = dev.type
        _BACKENDS[dev] = key
    return key


def default_backend() -> str:
    """The card's key when a card is present, else ``cpu``."""
    return backend_of("cuda") if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------
# persistent tuned.json store
# ---------------------------------------------------------------------------

_COMMITTED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tuned.json")


def default_path() -> str:
    return os.environ.get(ENV) or _COMMITTED


# path -> (mtime, entries): a store is re-read only when it changes
_ENTRY_CACHE: Dict[str, Tuple[float, Dict[str, Any]]] = {}
# (path, kernel, knob, dims, default, backend) -> resolve's answer
_RESOLVED: Dict[Tuple[Any, ...], Any] = {}


def clear_cache() -> None:
    """Forget every store read and every answer of :func:`resolve`."""
    _ENTRY_CACHE.clear()
    _RESOLVED.clear()


def _load_entries(path: str) -> Dict[str, Any]:
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    cached = _ENTRY_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    entries: Dict[str, Any] = {}
    try:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and isinstance(data.get("entries"), dict):
            entries = data["entries"]
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        entries = {}          # a corrupt file gives the defaults
    _ENTRY_CACHE[path] = (mtime, entries)
    return entries


class TunedStore:
    """Read/write view of one ``tuned.json``::

        {"version": 1,
         "entries": {"<kernel>|<shape-bucket>|<backend>":
                     {"config": {...}, "stats": {...}}}}

    Reads take a missing or corrupt file as empty; :meth:`save` writes a
    temporary file and renames it over the store."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path or default_path()
        self.entries: Dict[str, Any] = dict(_load_entries(self.path))

    @staticmethod
    def key(kernel: str, dims: Mapping[str, Any],
            backend: Optional[str] = None) -> str:
        return f"{kernel}|{shape_bucket(dims)}|{backend or default_backend()}"

    def get(self, kernel: str, dims: Mapping[str, Any],
            backend: Optional[str] = None) -> Dict[str, Any]:
        entry = self.entries.get(self.key(kernel, dims, backend))
        if isinstance(entry, dict) and isinstance(entry.get("config"), dict):
            return entry["config"]
        return {}

    def put(self, kernel: str, dims: Mapping[str, Any],
            config: Mapping[str, Any], *, backend: Optional[str] = None,
            stats: Optional[Mapping[str, Any]] = None) -> str:
        key = self.key(kernel, dims, backend)
        self.entries[key] = {"config": dict(config),
                             "stats": dict(stats or {})}
        return key

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": self.entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)
        _ENTRY_CACHE.pop(path, None)
        _RESOLVED.clear()
        return path


def resolve(kernel: str, dims: Mapping[str, Any], knob: str,
            default: Optional[Any] = None,
            backend: Optional[str] = None) -> Any:
    """The stored value of ``knob`` for this shape, or the default
    (``default``, else the kernel's ``DEFAULTS``) when the entry is
    missing, the file corrupt or the value no longer valid for ``dims``.
    Memoised until the next :meth:`TunedStore.save` or
    :func:`clear_cache`."""
    path = default_path()
    memo = (path, kernel, knob, tuple(sorted(dims.items())), default,
            backend)
    value = _RESOLVED.get(memo, _RESOLVED)
    if value is not _RESOLVED:
        return value
    if default is None:
        default = DEFAULTS.get(kernel, {}).get(knob)
    entry = _load_entries(path).get(TunedStore.key(kernel, dims, backend))
    value = default
    if isinstance(entry, dict) and isinstance(entry.get("config"), dict):
        value = entry["config"].get(knob, default)
        if not knob_valid(kernel, dims, knob, value):
            value = default
    _RESOLVED[memo] = value
    return value


# ---------------------------------------------------------------------------
# measured sweeps, timed through the obs layer
# ---------------------------------------------------------------------------

def measure(fn: Callable[[], Any], *, iters: int = 3, warmup: int = 1,
            tracer=None, label: str = "autotune",
            device: Any = None) -> float:
    """Median seconds of one call of ``fn()`` over ``iters`` calls, each
    recorded as a span on track ``"autotune"`` of ``tracer`` (its host
    start, the measured length). On the card (``device`` a CUDA device;
    None: the card when one is present): after ``warmup`` calls and a
    synchronise, each call is timed alone by CUDA events around it, behind
    a sleep kernel that keeps the stream busy while the host enqueues it,
    so the time is the card's without the wrapper's host share. On the
    CPU: the host's clock around each call."""
    if tracer is None:
        from repro_torch.obs import Tracer
        tracer = Tracer(enabled=True)
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    n = max(iters, 1)
    for _ in range(max(warmup, 0)):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(n)]
            starts = []
            for e0, e1 in ev:
                torch.cuda._sleep(FENCE_CYCLES)
                starts.append(time.perf_counter())
                e0.record()
                fn()
                e1.record()
            torch.cuda.synchronize(dev)
        for i, ((e0, e1), t0) in enumerate(zip(ev, starts)):
            tracer.record(label, "autotune", t0,
                          t0 + e0.elapsed_time(e1) / 1e3,
                          {"rep": i, "clock": "cuda_events"})
    else:
        for i in range(n):
            with tracer.span(label, track="autotune", rep=i):
                fn()
    spans = [s for s in tracer.spans()
             if s.track == "autotune" and s.name == label]
    return statistics.median(s.dur for s in spans[-n:])


def sweep(kernel: str, dims: Mapping[str, Any],
          run_fn: Callable[[Mapping[str, Any]], Callable[[], Any]], *,
          candidates: Optional[Sequence[Mapping[str, Any]]] = None,
          iters: int = 3, warmup: int = 1, tracer=None, metrics=None,
          store: Optional[TunedStore] = None, backend: Optional[str] = None,
          device: Any = None, save: bool = True) -> Dict[str, Any]:
    """Measure every candidate of one kernel at one shape and store the
    fastest. ``run_fn(config)`` returns a zero-argument callable that runs
    that variant. Each trial's seconds go into ``metrics`` (when given) as
    the histogram ``autotune_trial_seconds``, the best as
    ``autotune_<kernel>``; the winner lands in ``store`` (default: the
    store :func:`resolve` reads), saved unless ``save=False``."""
    cands = [dict(c) for c in (candidates if candidates is not None
                               else enumerate_candidates(kernel, dims))]
    if not cands:
        raise ValueError(f"no valid candidate of {kernel} at {dict(dims)}")
    bucket = shape_bucket(dims)
    trials: List[Dict[str, Any]] = []
    for cfg in cands:
        secs = measure(run_fn(cfg), iters=iters, warmup=warmup,
                       tracer=tracer, label=f"{kernel}:{bucket}",
                       device=device)
        trials.append({"config": cfg, "seconds": secs})
        if metrics is not None:
            metrics.histogram("autotune_trial_seconds",
                              "measured kernel-variant time",
                              labels={"kernel": kernel, "bucket": bucket,
                                      **cfg}).observe(secs)
    trials.sort(key=lambda t: t["seconds"])
    best = trials[0]
    if metrics is not None:
        metrics.publish(f"autotune_{kernel}",
                        {"best_seconds": best["seconds"],
                         "trials": len(trials)},
                        labels={"bucket": bucket})
    if store is None:
        store = TunedStore()
    key = store.put(kernel, dims, best["config"], backend=backend,
                    stats={"seconds": best["seconds"],
                           "trials": len(trials)})
    if save:
        store.save()
    return {"kernel": kernel, "bucket": bucket, "key": key, "best": best,
            "trials": trials}
