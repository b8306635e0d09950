"""Fault tolerance for the staged GR engine (the port of
``repro.training.resilience``).

Production GR trainers run continuously on impression streams, so a node
drop, a torn checkpoint or a poisoned batch must cost bounded work — not
the run. This module provides the two halves the engine composes:

* :class:`FaultPolicy` — what the engine *does* about a failing stage:
  per-stage retry with exponential backoff, a per-stage watchdog that
  flags (or fails) straggling stages, and a non-finite loss/grad guard
  that either skips the batch under a bounded skip budget or escalates to
  checkpoint recovery.

* :class:`FaultInjector` — deterministic failures for testing/benching:
  host exceptions, straggler delays and NaN poisoning at any of the seven
  pipeline stages at chosen (stage, step) sites, plus torn checkpoint
  writes (:func:`simulate_torn_save`) at chosen save steps. Every site
  fires exactly once, so a recovery replay re-executes the same steps
  clean — which is what makes the fail-and-recover trajectory
  bit-identical to an uninterrupted run (tests/test_torch_resilience.py).

Recovery itself lives in :meth:`repro_torch.training.engine.GREngine.
run_resilient`: on an escalated stage failure the pipeline drains
deterministically (``SixStagePipeline.run``'s ``finally`` joins every
in-flight hook), the engine restores the newest *intact* checkpoint —
always a carry-convention snapshot: τ=1 pending pairs + the pre-landing
table, the only resume-equivalent form — and replays from there.

One difference from the reference, whose stages commit their state after
computing it: the port's device stages write the training state in place
(``emb_bwd`` lands AdamW and AdaGrad, ``emb_fwd``/``dense_fwd`` may land a
run's leftover τ=1 pairs). :func:`wrap_stage_fn` therefore retries such a
stage only when it failed before its body ran (an injected fault); a
failure inside its body escalates to a restore, never to a retry.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core.pipeline import STAGES

SAVE_SITE = "save"          # pseudo-stage for torn-checkpoint injection
FAULT_KINDS = ("exception", "delay", "nan", "torn_save")


class InjectedFault(RuntimeError):
    """Deterministic test fault. Raised *before* the stage hook body runs
    (or in place of a checkpoint write), so a retry or a recovery replay
    always re-executes the stage from a clean slate."""


class NonFiniteLossError(RuntimeError):
    """The non-finite guard tripped and the policy escalated (skip budget
    exhausted, or ``nonfinite_action="recover"``)."""


class StageTimeoutError(RuntimeError):
    """A stage exceeded its watchdog timeout and the policy's
    ``straggler_action`` is ``"fail"``."""


@dataclass(frozen=True)
class FaultSpec:
    """One injection site: fire ``kind`` when ``stage`` runs for global
    step ``step`` (for ``kind="torn_save"``, when the checkpoint for
    ``step`` is written — ``stage`` must be :data:`SAVE_SITE`)."""
    stage: str
    step: int
    kind: str = "exception"
    delay_s: float = 0.0
    tear: str = "partial_dir"   # torn_save flavour (simulate_torn_save)

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind
        if self.kind == "torn_save":
            assert self.stage == SAVE_SITE, self.stage
        else:
            assert self.stage in STAGES, self.stage
        if self.kind == "nan":
            assert self.stage == "dense_fwd", \
                "NaN poisoning targets the dense_fwd artifact (the batch " \
                "itself is integer ids; the poison surfaces as a " \
                "non-finite loss at the dense_bwd guard)"


class FaultInjector:
    """Deterministic, fire-once fault injection at (stage, step) sites.

    The engine consults :meth:`take` as each stage hook runs for a global
    step; a matching unfired spec is consumed and acted on. Because a
    site fires exactly once, the post-recovery replay of the same steps
    runs clean — injection is reproducible but not persistent, modelling
    transient host faults, stragglers and poisoned batches.
    """

    def __init__(self, faults: Sequence[FaultSpec]):
        self._pending: List[FaultSpec] = list(faults)
        self.fired: List[FaultSpec] = []

    def take(self, stage: str, step: int) -> Optional[FaultSpec]:
        for k, spec in enumerate(self._pending):
            if spec.stage == stage and spec.step == step:
                self.fired.append(self._pending.pop(k))
                return spec
        return None

    @property
    def exhausted(self) -> bool:
        return not self._pending


@dataclass
class FaultPolicy:
    """Per-stage failure handling for the staged engine.

    retries: max re-invocations per stage after a failure (injected
        faults raise before the hook body, and the host stages — dataload,
        a2a, unique — are pure, so a retry is always clean). A stage that
        writes the state in place is retried only after a failure before
        its body (see :func:`wrap_stage_fn`). A stage not in the dict gets
        ``0`` retries: its failure escalates to checkpoint recovery.
    backoff_s: base of the exponential retry backoff
        (``backoff_s * 2**attempt`` seconds before attempt ``attempt+1``).
    stage_timeout_s: per-stage watchdog budget; a stage running longer is
        a straggler.
    straggler_action: "record" logs a ``("straggler", stage, step)``
        fault event and continues (the §4.1.3 token realloc bounds skew);
        "fail" raises :class:`StageTimeoutError` → recovery.
    guard_nonfinite / guard_grads: check the realized loss (and
        optionally the dense grads) for NaN/Inf at dense_bwd.
    nonfinite_action: "skip" drops the batch's update (state untouched)
        under ``max_skips``; "recover" escalates immediately. Either way
        the skip budget exhausting raises :class:`NonFiniteLossError`.
    max_recoveries: restore-and-replay attempts before the engine gives
        up and re-raises (a persistent fault must not loop forever).
    """
    retries: Dict[str, int] = field(
        default_factory=lambda: {"dataload": 2, "a2a": 2, "unique": 2})
    backoff_s: float = 0.0
    stage_timeout_s: Dict[str, float] = field(default_factory=dict)
    straggler_action: str = "record"          # "record" | "fail"
    guard_nonfinite: bool = True
    guard_grads: bool = False
    nonfinite_action: str = "recover"         # "recover" | "skip"
    max_skips: int = 0
    max_recoveries: int = 8

    def __post_init__(self):
        assert self.straggler_action in ("record", "fail")
        assert self.nonfinite_action in ("recover", "skip")


def wrap_stage_fn(stage: str, fn: Callable, *,
                  policy: Optional[FaultPolicy],
                  injector: Optional[FaultInjector],
                  global_step: Callable[[int], int],
                  fault_events: List[Tuple[str, str, int]],
                  poison: Optional[Callable[[int], None]] = None,
                  retry_body: bool = True) -> Callable:
    """Wrap one engine stage hook with injection + retry + watchdog.

    ``global_step(local_i)`` maps the hook's per-run batch index to the
    global step (recovery replays shift the base). Fault events append as
    ``(kind, stage, global_step)`` tuples — typed, so step 0 is
    unambiguous (the old ElasticRunner encoded stragglers as ``-step``,
    indistinguishable from a step-0 node failure). ``poison`` is the
    engine-provided NaN mutator for the dense_fwd artifact (the GR batch
    is integer ids, so a "poisoned batch" surfaces as a non-finite loss
    out of the dense stage — what the dense_bwd guard checks).
    ``retry_body=False`` marks a stage that writes the training state in
    place: a failure raised once its body has started (a real failure, or
    a watchdog "fail" after it) escalates at once, whatever its retry
    budget, since a retry could apply part of an update twice."""
    pol = policy or FaultPolicy()
    max_retries = pol.retries.get(stage, 0)
    timeout = pol.stage_timeout_s.get(stage)

    def wrapped(i: int, *args, **kwargs):
        g = global_step(i)
        for attempt in range(max_retries + 1):
            entered = False
            try:
                t0 = time.perf_counter()   # delays count against the watchdog
                spec = injector.take(stage, g) if injector else None
                if spec is not None:
                    if spec.kind == "exception":
                        fault_events.append(("injected", stage, g))
                        raise InjectedFault(
                            f"injected fault at {stage}(step {g})")
                    if spec.kind == "delay":
                        time.sleep(spec.delay_s)
                entered = True
                out = fn(i, *args, **kwargs)
                if timeout is not None and \
                        time.perf_counter() - t0 > timeout:
                    fault_events.append(("straggler", stage, g))
                    if pol.straggler_action == "fail":
                        raise StageTimeoutError(
                            f"{stage}(step {g}) exceeded {timeout}s "
                            f"watchdog")
                if spec is not None and spec.kind == "nan":
                    if poison is None:
                        raise RuntimeError(
                            "nan poisoning requires a poison mutator "
                            f"(stage {stage} has none)")
                    poison(i)
                    fault_events.append(("nan_poison", stage, g))
                return out
            except Exception:
                if attempt >= max_retries or (entered and not retry_body):
                    raise
                fault_events.append(("retry", stage, g))
                if pol.backoff_s:
                    time.sleep(pol.backoff_s * (2 ** attempt))
        raise AssertionError("unreachable")

    return wrapped


def _tensors(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif tree is not None:
        yield tree


def all_finite(tree: Any) -> bool:
    """Finiteness of every floating-point tensor (or array) of a nested
    dict/list/tuple: one device reduction per tensor, one host sync."""
    flags = []
    for leaf in _tensors(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point():
                flags.append(torch.isfinite(leaf).all())
        else:
            a = np.asarray(leaf)
            if a.dtype.kind == "f" and not np.isfinite(a).all():
                return False
    return bool(torch.stack(flags).all()) if flags else True


# -- torn checkpoint writes --------------------------------------------------

def simulate_torn_save(ckpt_dir: str, step: int, tree: Any, *,
                       tear: str = "partial_dir") -> None:
    """Crash a checkpoint save midway, leaving exactly the on-disk wreckage
    a real mid-save crash can produce. Restore/latest_step must skip it.

    tear="partial_dir"   step dir exists with some leaves but no manifest
                         (crash between leaf writes and the manifest)
    tear="truncated"     full dir but one leaf file truncated + published
                         (models a non-fsync'd save torn by power loss;
                         the last leaf, the 0-d step, no longer loads)
    tear="torn_latest"   intact step dir but LATEST is garbage bytes
                         (crash mid-pointer-write on a non-atomic FS)
    tear="bitflip"       full dir, but one byte in the middle of the
                         largest leaf's data flipped after publication (a
                         torn page the file's size does not show: the
                         leaf still loads, only its CRC refuses it)
    """
    import os

    from repro_torch.training import checkpoint as CKPT

    assert tear in ("partial_dir", "truncated", "torn_latest",
                    "bitflip"), tear
    os.makedirs(ckpt_dir, exist_ok=True)
    snap = CKPT.snapshot(tree)            # the state's leaves on the host
    n = len(snap.arrays)
    d = os.path.join(ckpt_dir, f"step_{step}")

    if tear == "partial_dir":
        os.makedirs(d, exist_ok=True)
        CKPT._write_leaves(d, snap, upto=max(1, n // 2), fsync=False)
        return                                # no manifest, LATEST untouched
    if tear == "truncated":
        CKPT.save(ckpt_dir, step, snap)       # full save, LATEST flips...
        victim = os.path.join(d, f"arr_{n - 1}.npy")
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:        # ...then the tail is lost
            f.truncate(max(1, size // 2))
        return
    if tear == "bitflip":
        CKPT.save(ckpt_dir, step, snap)
        big = max(range(n), key=lambda i: snap.arrays[i].nbytes)
        victim = os.path.join(d, f"arr_{big}.npy")
        pos = os.path.getsize(victim) - snap.arrays[big].nbytes // 2
        with open(victim, "r+b") as f:
            f.seek(pos)
            byte = f.read(1)
            f.seek(pos)
            f.write(bytes([byte[0] ^ 0xFF]))
        return
    # torn_latest: the step itself is fine; the pointer write tore
    CKPT.save(ckpt_dir, step, snap)
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write("step_")                      # garbage half-written name


@dataclass
class RecoveryEvent:
    """One recovery cycle in a resilient run (engine.fault_events holds
    the fine-grained (kind, stage, step) tuples; this is the summary the
    benchmarks read)."""
    failed_step: int
    restored_step: int
    error: str
    wall_s: float

    @property
    def steps_lost(self) -> int:
        return max(0, self.failed_step - self.restored_step)
