"""Staged GR execution engine — Algorithm 1 (§4.2.3) on real work (the port
of ``repro.training.engine``).

:class:`GREngine` wires the jagged loader, the host stages and the staged
train step (:func:`repro_torch.training.trainer.make_gr_stages`) into the
six-stage pipeline executor (:mod:`repro_torch.core.pipeline`), so the
model executes Algorithm 1: host stages on the executor's thread pool,
device stages enqueued on the main thread, and every ``StageEvent`` from
real work, which ``timeline_report`` reduces to Table 6's computing /
communication / not-overlapped / free breakdown.

Stage mapping (hook names are Algorithm 1's):

    dataload   GRLoader / data_fn → numpy jagged batch         (host pool)
    a2a        host→device copy of the batch: pinned memory, a
               side stream, an event the main stream waits on    (host pool)
    unique     no work: emb_bwd sorts the batch's table-grad
               slots on the card (the embedding cache, not
               ported, is what gives this stage work)           (host pool)
    emb_fwd    input-side gather — the τ=1-stale read (§4.2.2)  (main thread)
    dense_fwd  HSTU/FuXi stack + fused loss + backward,
               enqueued                                         (main thread)
    dense_bwd  the loss realised on the host (``.item()``)      (main thread)
    emb_bwd    device sort, unique pairs (K5) + AdamW +
               row-sparse AdaGrad                               (main thread)

Only the main thread launches kernels. The copies of the a2a stage run
on the engine's side stream; before ``emb_fwd`` of a batch the
main stream waits on their events, and each copied tensor is marked used
by the main stream (``record_stream``), so the caching allocator does not
hand its memory to the side stream again while main-stream work may read
it.

τ=1 with an in-place table. The reference's pipelined ``emb_bwd(i)`` lands
the batch's pairs at once and hands ``step_callback`` the pre-landing
table, an immutable array. Here the master, the shadow and the AdaGrad
accumulator are updated in place (a copy would be 43 GB at ``hstu-large``),
so in the pipelined steady state ``emb_bwd(i)``

  1. computes the unique pairs without applying them,
  2. calls ``step_callback`` with the carry-convention state (the pairs
     pending, the table not yet landed: what ``make_gr_train_step`` holds
     after step i), and
  3. lands the pairs in place and clears the carry.

``dense_fwd(i+1)`` (Algorithm 1 line 4) follows that landing, as the flat
τ=1 step's dense stream follows its landing. ``emb_fwd(i+2)`` (line 7)
runs after ``emb_bwd(i)`` and before ``emb_bwd(i+1)``, so it gathers batch
i+2's rows from the master with batches ≤ i landed: the one-step-stale
read of the flat τ=1 step, which gathers them before batch i+1's pairs
land. The gather is a copy, so later landings do not reach it. With
``schedule="flat"`` the same stages run serially one batch at a time. Both
schedules are bit-identical to :func:`make_gr_train_step`, sync and τ=1:
losses, the final state and the carry.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue 1 item when given): the host-offloaded embedding cache (``cache``,
item 10), fault tolerance (``fault_policy``, ``fault_injector`` and
:meth:`GREngine.run_resilient`, item 9) and telemetry (``obs``, item 8).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.pipeline import (PipelineHooks, STAGES, SixStagePipeline,
                                       StageEvent,
                                       timeline_report as _timeline_report)
from repro_torch.training.trainer import (GRTrainState, gr_train_state,
                                          make_gr_stages, make_gr_train_step,
                                          to_device)

SCHEDULES = ("algorithm1", "flat")

_NOT_PORTED = {"cache": 10, "fault_policy": 9, "fault_injector": 9, "obs": 8}


def _bundle_loss_fn(bundle, loss_kwargs: Optional[Dict[str, Any]]):
    lk = dict(loss_kwargs or {})
    return lambda d, t, b, **kw: bundle.loss(d, t, b, **lk, **kw)


def make_gr_step_fn(bundle, *, loss_kwargs: Optional[Dict[str, Any]] = None,
                    lr_dense: float = 4e-3, lr_sparse: float = 4e-3,
                    semi_async: bool = True):
    """The engine's flat train step as a standalone ``(state, batch) ->
    (state, metrics)`` function: what ``GREngine(schedule="flat")``
    computes, and what both schedules are bit-identical to."""
    return make_gr_train_step(_bundle_loss_fn(bundle, loss_kwargs),
                              input_gather=bundle.input_gather,
                              lr_dense=lr_dense, lr_sparse=lr_sparse,
                              semi_async=semi_async)


class GREngine:
    """Staged training engine for the GR workload.

    Parameters
    ----------
    bundle: ``GRBundle`` (model + loss).
    data: a ``GRLoader`` (its ``batches(steps)`` iterator feeds the
        dataload stage) or a callable ``data_fn(i) -> batch`` of numpy
        batches.
    state: a :class:`GRTrainState` to train in place; default: one built
        from ``bundle`` with a generator seeded by ``seed`` on ``device``
        (None = the card, which raises without one; ``"cpu"`` runs the
        kernels' plain versions). A given state trains where it lies.
    loss_kwargs: bound into ``bundle.loss`` (expansion, neg_segment,
        neg_scatter_impl, ...).
    schedule: "algorithm1" (six-stage pipelined execution) or "flat"
        (same stages, serial per step).
    step_callback: optional ``fn(i, record, state)`` invoked after each
        ``emb_bwd``. ``state`` is always the carry-convention state (τ=1
        pairs pending, table not yet landed), what the flat step holds
        after step ``i``; its tensors are updated in place by the steps
        that follow, so a callback that keeps it copies it.
    cache, fault_policy, fault_injector, obs: not ported yet; given a
        value, they raise ``NotImplementedError``.

    ``run(steps)`` returns a list of per-step records ``{"step", "loss",
    "tokens"}``; ``events`` holds the run's :class:`StageEvent` trace and
    :meth:`timeline_report` reduces it to the Table-6 breakdown.
    """

    def __init__(self, bundle, data, *, state: Optional[GRTrainState] = None,
                 seed: int = 0, loss_kwargs: Optional[Dict[str, Any]] = None,
                 lr_dense: float = 4e-3, lr_sparse: float = 4e-3,
                 semi_async: bool = True, schedule: str = "algorithm1",
                 qdtype=torch.float16, workers: int = 3,
                 step_callback: Optional[Callable] = None,
                 device: DeviceLike = None, cache=None, fault_policy=None,
                 fault_injector=None, obs=None):
        given = dict(cache=cache, fault_policy=fault_policy,
                     fault_injector=fault_injector, obs=obs)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"GREngine({name}=...) is not ported yet: ROADMAP "
                    f"queue 1, item {_NOT_PORTED[name]}")
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}")
        if state is not None and device is not None:
            raise ValueError("pass a state or a device, not both: a given "
                             "state trains where it lies")
        if state is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            state = gr_train_state(bundle.init_dense(gen, device=dev),
                                   bundle.init_table(gen, device=dev),
                                   qdtype=qdtype)
        self.bundle = bundle
        self.loader = None if callable(data) else data
        self._data_fn = data if callable(data) else None
        self.state = state
        self.device = state.table.master.device
        self.semi_async = semi_async
        self.schedule = schedule
        self.workers = workers
        self.step_callback = step_callback
        self.events: List[StageEvent] = []
        self.stages = make_gr_stages(_bundle_loss_fn(bundle, loss_kwargs),
                                     input_gather=bundle.input_gather,
                                     lr_dense=lr_dense, lr_sparse=lr_sparse,
                                     semi_async=semi_async)
        self._h2d = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)
        self._dlock = threading.Lock()

    # -- data --------------------------------------------------------------
    def _batch(self, i: int):
        """Deterministic index → batch mapping, safe under the executor's
        thread pool (dataload futures may run out of order; GRLoader is
        RNG-stateful, so batches are fetched in order under a lock)."""
        with self._dlock:
            while i >= len(self._bcache):
                j = len(self._bcache)
                self._bcache.append(self._data_fn(j)
                                    if self._data_fn is not None
                                    else next(self._batch_iter))
            return self._bcache[i]

    def _upload(self, arrays: Dict[str, np.ndarray]):
        """numpy arrays → (tensors on the engine's device, the event the
        main stream waits on before using them, or None on the CPU)."""
        if self._h2d is None:
            return to_device(arrays, self.device), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._h2d):
            out = to_device(arrays, self.device, pin=True)
            ev = torch.cuda.Event()
            ev.record(self._h2d)
        return out, ev

    def _await_uploads(self, art) -> None:
        if self._h2d is None:
            return
        main = torch.cuda.current_stream(self.device)
        for ev in art["events"]:
            main.wait_event(ev)
        for t in art["dev"].values():
            t.record_stream(main)

    # -- per-run setup -----------------------------------------------------
    def _prepare_run(self, steps: int):
        self._batch_iter = (self.loader.batches(steps)
                            if self.loader is not None else None)
        self._bcache: List[Any] = []
        self._arts: Dict[int, Dict[str, Any]] = {}
        self.events = []
        self._run_last = steps - 1
        # τ=1 pairs left pending by a previous run land mid-prologue:
        # after emb_fwd(0) — whose input read is one step stale, exactly as
        # the flat step orders it — and before emb_fwd(1) / dense_fwd(0).
        self._leftover = (self.semi_async
                          and self.state.pending_ids.numel() > 0)

    def _land_pending(self):
        st = self.state
        table = self.stages.sparse_apply(st.table, st.pending_ids,
                                         st.pending_rows)
        # new empty tensors: a [:0] view would keep the carry's storage
        self.state = st._replace(
            table=table, pending_ids=st.pending_ids.new_zeros((0,)),
            pending_rows=st.pending_rows.new_zeros(
                (0, st.pending_rows.shape[1])))

    def _maybe_land_leftover(self, i: int, stage: str):
        if not self._leftover:
            return
        if stage == "emb_fwd" and i == 0:
            return                      # batch 0's input read stays stale
        self._land_pending()
        self._leftover = False

    # -- Algorithm-1 hooks -------------------------------------------------
    def _hk_dataload(self, i: int):
        return self._batch(i)

    def _hk_a2a(self, i: int, nb):
        dev, ev = self._upload(nb)
        return {"np": nb, "dev": dev, "events": [ev]}

    def _hk_unique(self, i: int, art):
        # emb_bwd sorts the step's slots on the card; this stage has no
        # work until the embedding cache (ROADMAP item 10) needs the
        # candidate counts
        return art

    def _hk_emb_fwd(self, i: int, art):
        self._await_uploads(art)
        self._maybe_land_leftover(i, "emb_fwd")
        if self.semi_async:
            return {**art, "x": self.stages.emb_fwd(self.state.table.master,
                                                    art["dev"])}
        return art

    def _hk_dense_fwd(self, i: int, art):
        self._maybe_land_leftover(i, "dense_fwd")
        st = self.state
        dout = self.stages.dense_fwd_bwd(st.dense, st.table, art["dev"],
                                         art.get("x"))
        self._arts[i] = {**art, "dout": dout}
        return {"i": i}

    def _hk_dense_bwd(self, i: int, art):
        full = self._arts[i]
        loss = float(full["dout"].loss)   # realise the enqueued fwd+bwd
        tokens = int(np.asarray(full["np"]["offsets"])[:, -1].sum())
        return {"step": i, "loss": loss, "tokens": tokens}

    def _hk_emb_bwd(self, i: int, rec, *, defer_sparse: bool = False):
        full = self._arts.pop(i)
        st = self.state
        dense, opt, table, p_ids, p_rows = self.stages.emb_bwd(
            st.dense, st.dense_opt, st.table, full["dout"], full["dev"],
            apply_sparse=not self.semi_async)
        if not self.semi_async:
            p_ids, p_rows = st.pending_ids[:0], st.pending_rows[:0]
        # τ=1: the carry-convention state, the pairs pending
        self.state = GRTrainState(dense, opt, table, p_ids, p_rows,
                                  st.step + 1)
        self._bcache[i] = None            # free the consumed numpy batch
        if self.step_callback:
            self.step_callback(i, rec, self.state)
        if self.semi_async and not (defer_sparse or i == self._run_last):
            # pipelined steady state: land now, in place, after the
            # callback saw the carry — dense_fwd(i+1) is the next stage
            self._land_pending()
        return rec

    def _make_hooks(self) -> PipelineHooks:
        return PipelineHooks(**{s: getattr(self, f"_hk_{s}")
                                for s in STAGES})

    # -- run ---------------------------------------------------------------
    def run(self, steps: int) -> List[Dict[str, Any]]:
        """Train ``steps`` batches; returns per-step records."""
        if steps <= 0:
            return []
        self._prepare_run(steps)
        if self.schedule == "algorithm1":
            pipe = SixStagePipeline(self._make_hooks(), workers=self.workers)
            results = pipe.run(steps)
            self.events = list(pipe.events)
        else:
            results = self._run_flat(steps)
        return results

    def _run_flat(self, steps: int) -> List[Dict[str, Any]]:
        """Serial per-step execution of the same stages (no pipelining),
        with the same τ=1 dataflow: batch i−1's pairs land *after* batch
        i's input gather."""
        results = []

        def stage(name, i, *a, **kw):
            t0 = time.perf_counter()
            out = getattr(self, f"_hk_{name}")(i, *a, **kw)
            self.events.append(StageEvent(name, i, t0, time.perf_counter()))
            return out

        self._leftover = False            # flat lands pending every step
        for i in range(steps):
            nb = stage("dataload", i)
            art = stage("a2a", i, nb)
            art = stage("unique", i, art)
            art = stage("emb_fwd", i, art)
            if self.semi_async:
                # the sparse half of emb_bwd(i−1): the delayed landing
                t0 = time.perf_counter()
                self._land_pending()
                if i > 0:
                    self.events.append(
                        StageEvent("emb_bwd", i - 1, t0,
                                   time.perf_counter()))
            small = stage("dense_fwd", i, art)
            rec = stage("dense_bwd", i, small)
            stage("emb_bwd", i, rec, defer_sparse=True)
            results.append(rec)
        return results

    def run_resilient(self, *args, **kwargs):
        """Supervised training with checkpoints and recovery: not ported
        yet."""
        raise NotImplementedError(
            "GREngine.run_resilient is not ported yet: ROADMAP queue 1, "
            "item 9 (checkpointing and fault tolerance)")

    # -- reporting ---------------------------------------------------------
    def timeline_report(self) -> Dict[str, Any]:
        """Table-6 breakdown of the last run's real stage events."""
        return _timeline_report(self.events)
