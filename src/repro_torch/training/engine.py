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

Fault tolerance (``fault_policy``, ``fault_injector``,
:meth:`GREngine.run_resilient`) and telemetry (``obs``) follow the
reference; where the in-place state changes what they must do:

* A checkpoint's host copy is complete before ``step_callback`` returns
  (the steps that follow overwrite the carry-convention state's tensors);
  only the file writes run on the saver's thread. The replay-from-scratch
  anchor of a resilient run is a host copy made by the same code, and no
  file: the state object it came from is trained in place.
* Retries. :data:`RETRY_SAFE_STAGES` (dataload, a2a, unique, dense_bwd)
  change no training state and are retried whenever the policy allows;
  emb_fwd, dense_fwd and emb_bwd write it in place (AdamW and AdaGrad in
  emb_bwd, a leftover τ=1 landing in the other two), so they are retried
  only after a failure raised before their body ran (an injected fault),
  and a failure inside their body escalates to a restore.
* A CUDA error is not masked: a recovery's restore writes into the state's
  tensors on the card, so a sticky error (an illegal address, a
  device-side assert) fails that restore and is raised; any error is
  raised once ``max_recoveries`` restores are used up.
* Telemetry adds no synchronisation: a step's wall is the host's time
  between the realisations of consecutive losses in dense_bwd (which waits
  for the card), and the stage spans are the host's time in each hook, so
  on the card the spans of the stages that only enqueue kernels show their
  launch time, not their device time.

The host-offloaded embedding cache (``cache``) is not ported yet: given a
value it raises ``NotImplementedError`` naming ROADMAP queue 1 item 10.
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
from repro_torch.obs import (Obs, gr_dense_params, measured_mfu,
                             peak_flops_of, pipeline_goodput, token_imbalance)
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import resilience as R
from repro_torch.training.trainer import (GRTrainState, gr_train_state,
                                          make_gr_stages, make_gr_train_step,
                                          to_device)

SCHEDULES = ("algorithm1", "flat")

#: Stages that change no training state: a retry after any failure is
#: clean. The others write it in place (see the module docstring).
RETRY_SAFE_STAGES = ("dataload", "a2a", "unique", "dense_bwd")


def _step_fns(bundle, loss_kwargs: Optional[Dict[str, Any]]):
    """(the loss with ``loss_kwargs`` bound, the input gather and label
    lookup of its ``lookup_fn`` (None: the plain gather) as the stages'
    keyword arguments): one rule for the flat step and the engine, so they
    never disagree on the dataflow."""
    lk = dict(loss_kwargs or {})
    lookup_fn = lk.get("lookup_fn")
    return (lambda d, t, b, **kw: bundle.loss(d, t, b, **lk, **kw),
            dict(input_gather=lambda t, b: bundle.input_gather(
                t, b, lookup_fn=lookup_fn), lookup_fn=lookup_fn))


def make_gr_step_fn(bundle, *, loss_kwargs: Optional[Dict[str, Any]] = None,
                    lr_dense: float = 4e-3, lr_sparse: float = 4e-3,
                    semi_async: bool = True):
    """The engine's flat train step as a standalone ``(state, batch) ->
    (state, metrics)`` function: what ``GREngine(schedule="flat")``
    computes, and what both schedules are bit-identical to."""
    loss_fn, fns = _step_fns(bundle, loss_kwargs)
    return make_gr_train_step(loss_fn, **fns, lr_dense=lr_dense,
                              lr_sparse=lr_sparse, semi_async=semi_async)


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
    loss_kwargs: bound into ``bundle.loss`` (neg_mode, expansion,
        neg_segment, neg_scatter_impl, attn_fn, lookup_fn, ...); a
        ``lookup_fn`` also gathers the input rows in emb_fwd and the label
        rows in dense_fwd.
    schedule: "algorithm1" (six-stage pipelined execution) or "flat"
        (same stages, serial per step).
    step_callback: optional ``fn(i, record, state)`` invoked after each
        ``emb_bwd``. ``state`` is always the carry-convention state (τ=1
        pairs pending, table not yet landed), what the flat step holds
        after step ``i``; its tensors are updated in place by the steps
        that follow, so a callback that keeps it copies it.
    fault_policy, fault_injector: per-stage retry / watchdog / non-finite
        handling and deterministic fault injection
        (:mod:`repro_torch.training.resilience`); :meth:`run_resilient`
        sets them for its run.
    obs: an :class:`repro_torch.obs.Obs`; when enabled, each record gains
        ``step_wall_s``, ``mfu`` and ``imbalance``, the registry the
        reference's ``train_*`` metrics, and the tracer one span per stage
        event at the end of a run. ``peak_flops``: the peak the measured MFU
        is taken against (default: the cited peak of the card, by name and
        the model's dtype; the CPU has none, so obs on the CPU needs it).
    cache: not ported yet; given a value, it raises
        ``NotImplementedError``.

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
                 device: DeviceLike = None, cache=None,
                 fault_policy: Optional[R.FaultPolicy] = None,
                 fault_injector: Optional[R.FaultInjector] = None,
                 obs: Optional[Obs] = None,
                 peak_flops: Optional[float] = None):
        if cache is not None:
            raise NotImplementedError(
                "GREngine(cache=...) is not ported yet: ROADMAP queue 1, "
                "item 10 (the host-offloaded embedding cache)")
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
        loss_fn, fns = _step_fns(bundle, loss_kwargs)
        self.stages = make_gr_stages(loss_fn, **fns,
                                     lr_dense=lr_dense, lr_sparse=lr_sparse,
                                     semi_async=semi_async)
        self._h2d = (torch.cuda.Stream(self.device)
                     if self.device.type == "cuda" else None)
        self._dlock = threading.Lock()
        # -- fault tolerance (training/resilience.py) ----------------------
        self._policy = fault_policy
        self._injector = fault_injector
        self._resume_base = 0            # global step of this run's batch 0
        self._skips_used = 0
        self.fault_events: List[tuple] = []   # typed (kind, stage, step)
        self.recoveries: List[R.RecoveryEvent] = []
        #: (global step, D2H seconds, bytes) of each checkpoint's host copy
        self.snapshots: List[tuple] = []
        # -- observability (obs/) ------------------------------------------
        # _mx/_tr are None unless obs is live, so every instrumentation
        # site is a single attribute test on the hot path
        self.obs = obs
        live = obs is not None and obs.enabled
        self._mx = obs.metrics if live else None
        self._tr = obs.tracer if live else None
        # measured MFU: model FLOPs for GR = 6 * dense params * tokens
        self._obs_flops_per_token = (
            6.0 * gr_dense_params(bundle.cfg) if live else 0.0)
        self.peak_flops = (peak_flops_of(
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else self.device.type,
            bundle.cfg.dtype, peak_flops) if live else peak_flops)
        self._last_step_end: Optional[float] = None
        self._run_t0 = 0.0

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
        self._last_step_end = None
        self._run_t0 = time.perf_counter()
        # stage hooks, wrapped with fault injection / retry / watchdog
        # when a policy or injector is attached (run_resilient sets them);
        # the unwrapped path is the plain engine's
        base_fns = {s: getattr(self, f"_hk_{s}") for s in STAGES}
        if self._policy is not None or self._injector is not None:
            self._stage_fns = {
                s: R.wrap_stage_fn(
                    s, fn, policy=self._policy, injector=self._injector,
                    global_step=lambda i: self._resume_base + i,
                    fault_events=self.fault_events,
                    poison=self._poison_dout if s == "dense_fwd" else None,
                    retry_body=s in RETRY_SAFE_STAGES)
                for s, fn in base_fns.items()}
        else:
            self._stage_fns = base_fns

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

    def _poison_dout(self, i: int):
        """FaultInjector 'nan' mutator: NaN the dense_fwd artifact's loss
        (the GR batch is integer ids, so a poisoned batch shows exactly
        here: a non-finite loss out of the dense stage)."""
        full = self._arts[i]
        full["dout"] = full["dout"]._replace(
            loss=torch.full_like(full["dout"].loss, float("nan")))

    def _hk_dense_bwd(self, i: int, art):
        full = self._arts[i]
        loss = float(full["dout"].loss)   # realise the enqueued fwd+bwd
        tokens = int(np.asarray(full["np"]["offsets"])[:, -1].sum())
        rec = {"step": i, "loss": loss, "tokens": tokens}
        if self._mx is not None:
            # dense_bwd realises the loss on the main thread in both
            # schedules, so step-boundary timestamps need no lock
            self._obs_step(i, rec, full)
        pol = self._policy
        if pol is not None and pol.guard_nonfinite:
            bad = not np.isfinite(loss)
            if not bad and pol.guard_grads:
                bad = not R.all_finite(full["dout"].grads_dense)
            if bad:
                g = self._resume_base + i
                if (pol.nonfinite_action == "skip"
                        and self._skips_used < pol.max_skips):
                    self._skips_used += 1
                    self.fault_events.append(
                        ("skip_nonfinite", "dense_bwd", g))
                    rec["skipped"] = True
                else:
                    raise R.NonFiniteLossError(
                        f"non-finite loss at step {g} "
                        f"(skip budget {pol.max_skips} exhausted)"
                        if pol.nonfinite_action == "skip" else
                        f"non-finite loss at step {g}")
        return rec

    def _hk_emb_bwd(self, i: int, rec, *, defer_sparse: bool = False):
        full = self._arts.pop(i)
        st = self.state
        if rec.get("skipped"):
            # the non-finite guard dropped this batch: no optimizer step,
            # no pairs; the state is untouched and is its own
            # carry-convention state
            self._bcache[i] = None
            if self.step_callback:
                self.step_callback(i, rec, st)
            return rec
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
        return PipelineHooks(**self._stage_fns)

    # -- observability -----------------------------------------------------
    def _obs_step(self, i: int, rec: Dict[str, Any],
                  full: Dict[str, Any]) -> None:
        """Per-step derived gauges: the step's wall (the host's time since
        the last step's loss was realised, or since the run began), the
        measured MFU against ``peak_flops`` and the per-device token-load
        imbalance; the values also ride the record."""
        now = time.perf_counter()
        prev = (self._last_step_end if self._last_step_end is not None
                else self._run_t0)
        self._last_step_end = now
        wall = now - prev
        loads = np.asarray(full["np"]["offsets"])[:, -1]
        rec["step_wall_s"] = wall
        rec["mfu"] = measured_mfu(self._obs_flops_per_token * rec["tokens"],
                                  wall, self.peak_flops)
        rec["imbalance"] = token_imbalance(loads)
        mx = self._mx
        mx.counter("train_steps_total", "training steps completed").inc()
        mx.counter("train_tokens_total", "tokens trained").inc(rec["tokens"])
        mx.gauge("train_step", "last completed global step").set(
            self._resume_base + i)
        mx.gauge("train_loss", "last step loss").set(rec["loss"])
        mx.gauge("train_step_wall_s", "last step wall time").set(wall)
        mx.gauge("train_mfu_measured",
                 "measured model-FLOPs utilization").set(rec["mfu"])
        mx.gauge("train_token_imbalance",
                 "per-device token-load imbalance").set(rec["imbalance"])
        if wall > 0.0:
            mx.gauge("train_tokens_per_s", "training throughput").set(
                rec["tokens"] / wall)
        mx.histogram("train_step_s", "step wall time").observe(wall)

    def _obs_finalize(self, results: List[Dict[str, Any]]) -> None:
        """End of a run: the stage events as spans (one track per merged
        stage), the Table-6 breakdown and the pipeline's goodput/bubble."""
        if self._mx is None:
            return
        recs = {r["step"]: r for r in results}
        self._tr.ingest_stage_events(self.events, records=recs)
        tl = self.timeline_report()
        if tl:
            self._mx.publish("train_timeline", tl)
        gp = pipeline_goodput(self.events)
        self._mx.gauge("train_pipeline_goodput",
                       "busy/wall of the stage stream").set(gp["goodput"])
        self._mx.gauge("train_pipeline_bubble_ratio",
                       "1 - goodput").set(gp["bubble_ratio"])

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
        self._obs_finalize(results)
        return results

    def _run_flat(self, steps: int) -> List[Dict[str, Any]]:
        """Serial per-step execution of the same stages (no pipelining),
        with the same τ=1 dataflow: batch i−1's pairs land *after* batch
        i's input gather."""
        results = []

        def stage(name, i, *a, **kw):
            t0 = time.perf_counter()
            out = self._stage_fns[name](i, *a, **kw)
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

    # -- supervised recovery -----------------------------------------------
    def _global_fetch(self) -> Callable[[int], Any]:
        """Deterministic global-step → batch mapping that survives recovery
        replays. ``data_fn`` engines fetch on demand; loader engines pull
        from one iterator into a cache, because ``GRLoader.batches`` is
        RNG-stateful and restarting it would change the replayed batches
        (the cache holds the run's batches on the host)."""
        cache: Dict[int, Any] = {}
        if self._data_fn is not None:
            src = self._data_fn

            def fetch(g: int):
                if g not in cache:
                    cache[g] = src(g)
                return cache[g]
            return fetch
        loader, it = self.loader, None

        def fetch_loader(g: int):
            nonlocal it
            if it is None:
                it = loader.batches(self._resilient_steps)
            while len(cache) <= g:
                cache[len(cache)] = next(it)
            return cache[g]
        return fetch_loader

    def _write_ckpt(self, saver, ckpt_dir: str, step_num: int, snapshot,
                    keep_last_n) -> None:
        """One checkpoint inside a resilient run, of the carry-convention
        state (τ=1 pairs pending, table not landed); its host copy is
        complete when this returns. A torn-save injection site for this
        step crashes the write as a real mid-save failure would (wreckage
        on disk, then the run fails): recovery must fall back to the
        previous intact step."""
        spec = (self._injector.take(R.SAVE_SITE, step_num)
                if self._injector else None)
        if spec is not None and spec.kind == "torn_save":
            if saver is not None:
                try:
                    saver.wait()          # serialize with in-flight save
                except Exception:
                    pass
            self.fault_events.append(("torn_save", R.SAVE_SITE, step_num))
            R.simulate_torn_save(ckpt_dir, step_num, snapshot,
                                 tear=spec.tear)
            raise R.InjectedFault(
                f"crash mid-save of step {step_num} ({spec.tear})")
        if saver is not None:
            saver.save_async(step_num, snapshot)
            self.snapshots.append(saver.snapshots[-1])
        else:
            snap = CKPT.snapshot(snapshot)
            self.snapshots.append((step_num, snap.seconds, snap.nbytes))
            CKPT.save(ckpt_dir, step_num, snap, keep_last_n=keep_last_n,
                      registry=self._mx)

    def run_resilient(self, steps: int, *, ckpt_dir: str,
                      ckpt_every: int = 10,
                      policy: Optional[R.FaultPolicy] = None,
                      injector: Optional[R.FaultInjector] = None,
                      keep_last_n: Optional[int] = None,
                      async_save: bool = True, final_save: bool = True,
                      start_step: Optional[int] = None
                      ) -> List[Dict[str, Any]]:
        """Train to global step ``steps`` under supervision: a
        crash-consistent checkpoint every ``ckpt_every`` steps (and after
        the last, ``final_save``), per-stage retry/watchdog/non-finite
        handling per ``policy``, and on any escalated stage failure a full
        recovery cycle — the pipeline drains (every in-flight hook joins),
        the newest *intact* checkpoint is restored into the state's tensors
        (falling back past torn saves; the run's initial state, kept as a
        host copy, if none exists yet) and the remaining steps replay.
        Checkpoints hold the carry-convention state, so a failed-and-
        recovered run is bit-identical to an uninterrupted one in both
        schedules, sync and τ=1.

        Returns the per-step records for global steps ``[start, steps)`` in
        order (``start`` defaults to ``state.step``; a record replayed
        after a recovery overwrites its first, identical, incarnation).
        ``fault_events`` collects typed ``(kind, stage, step)`` events,
        ``recoveries`` one :class:`RecoveryEvent` per restore cycle and
        ``snapshots`` each checkpoint's host copy (step, seconds, bytes).
        """
        pol = policy if policy is not None else R.FaultPolicy()
        prev_pol, prev_inj = self._policy, self._injector
        prev_cb, prev_data = self.step_callback, self._data_fn
        self._policy, self._injector = pol, injector
        self.fault_events = []
        self.recoveries = []
        self.snapshots = []
        self._skips_used = 0
        self._resilient_steps = steps
        base0 = start_step if start_step is not None else int(self.state.step)
        if base0 >= steps:
            return []
        fetch = self._global_fetch()
        records: Dict[int, Dict[str, Any]] = {}
        # replay-from-scratch anchor: a host copy (the state object itself
        # is trained in place); nothing is written to disk for it. A
        # directory that already holds an intact step at or after the
        # start (a resumed run) is restored from instead, and always will
        # hold one: a save removes old steps only after a newer one is
        # complete.
        keep_anchor = not any(s >= base0 for s in CKPT.intact_steps(ckpt_dir))
        # host copies of the whole state alive at once: the saver's (on
        # the card its pinned buffers, kept for the run: the copy stalls
        # the training thread, and pageable memory is many times slower),
        # a restore's read of the leaves, and the anchor
        need = CKPT.host_nbytes(self.state) * (2 + keep_anchor)
        avail = CKPT.host_available_bytes()
        if avail is not None and need > avail:
            raise MemoryError(
                f"run_resilient needs {need / 1e9:.2f} GB of host memory "
                f"for {2 + keep_anchor} copies of the state (the saver's, "
                f"a restore's" + (", the replay anchor" if keep_anchor
                                  else "") + f"), {avail / 1e9:.2f} GB "
                f"available")
        saver = (CKPT.AsyncCheckpointer(ckpt_dir, keep_last_n=keep_last_n,
                                        registry=self._mx)
                 if async_save else None)
        initial = CKPT.snapshot(self.state) if keep_anchor else None

        def on_step(i: int, rec: Dict[str, Any], snapshot) -> None:
            g = self._resume_base + i
            grec = dict(rec, step=g)
            records[g] = grec
            if prev_cb:
                prev_cb(g, grec, snapshot)
            done = g + 1
            if (ckpt_every and done % ckpt_every == 0) or \
                    (final_save and done == steps):
                self._write_ckpt(saver, ckpt_dir, done, snapshot,
                                 keep_last_n)

        self.step_callback = on_step
        prev_loader, self.loader = self.loader, None
        self._data_fn = lambda i: fetch(self._resume_base + i)
        base = base0
        try:
            while True:
                self._resume_base = base
                try:
                    self.run(steps - base)
                    break
                except Exception as err:
                    t0 = time.perf_counter()
                    if saver is not None:
                        try:
                            saver.wait()   # surface/serialize async saves
                        except Exception:
                            pass           # a torn async save is recovered
                    if len(self.recoveries) >= pol.max_recoveries:
                        raise
                    failed = max(records, default=base - 1) + 1
                    try:
                        self.state, used = CKPT.restore_with_step(
                            ckpt_dir, self.state, registry=self._mx)
                    except (FileNotFoundError, CKPT.CheckpointCorrupt):
                        if initial is None:
                            raise     # the start's intact steps are gone
                        # no intact checkpoint yet: replay from the anchor
                        self.state = CKPT.load_snapshot(self.state, initial)
                        used = base0
                    for g in [g for g in records if g >= used]:
                        del records[g]
                    base = used
                    ev = R.RecoveryEvent(
                        failed_step=failed, restored_step=used,
                        error=repr(err),
                        wall_s=time.perf_counter() - t0)
                    self.recoveries.append(ev)
                    self.fault_events.append(("recovered", "engine", used))
                    if self._mx is not None:
                        self._mx.counter(
                            "train_recoveries_total",
                            "recovery cycles completed").inc()
                        self._mx.counter(
                            "train_steps_replayed_total",
                            "steps lost to recoveries").inc(ev.steps_lost)
                        self._mx.gauge(
                            "train_last_recovery_wall_s",
                            "wall time of the last recovery").set(ev.wall_s)
                        self._mx.histogram(
                            "train_recovery_s",
                            "recovery wall time").observe(ev.wall_s)
                    if self._tr is not None:
                        # (t0, t0 + wall_s) is the restore window on the
                        # run's timeline
                        self._tr.record(
                            "recovery", "recovery", t0, t0 + ev.wall_s,
                            {"failed_step": failed, "restored_step": used,
                             "steps_lost": ev.steps_lost,
                             "error": repr(err)})
        finally:
            self.step_callback = prev_cb
            self._policy, self._injector = prev_pol, prev_inj
            self._data_fn, self.loader = prev_data, prev_loader
            self._resume_base = 0
            if saver is not None:
                saver.wait()
        return [records[g] for g in sorted(records)]


    # -- reporting ---------------------------------------------------------
    def timeline_report(self) -> Dict[str, Any]:
        """Table-6 breakdown of the last run's real stage events."""
        return _timeline_report(self.events)
