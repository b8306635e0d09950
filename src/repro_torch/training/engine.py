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
    unique     no work without a cache (emb_bwd sorts the table-grad
               slots on the card); with one, the cache prefetch:
               pin, swap in, translate ids to window rows      (host pool)
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
  only the file writes run on the saver's thread. With a cache the copy
  holds no table: its leaves stream from the host store on the saver's
  thread (:meth:`GREngine.checkpoint_tree`). The replay-from-scratch
  anchor of a resilient run is a host copy of the full state, and no file:
  the state object it came from is trained in place. It is kept only until
  the run's first save has been written (from then on the directory holds
  an intact step to restore).
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

The host-offloaded embedding cache (``cache``, a
:class:`~repro_torch.embedding.cache.CachedShadowedTable`): the state's
table is the cache's window on the card and the full table lives in host
RAM. The a2a stage leaves the id features on the host; the unique stage
(a worker thread) pins the batch's chunks, writes dirty victims back,
copies the missing chunks to the card on the cache's stream, translates the
id features to window rows and uploads them; ``emb_fwd`` splices the
chunks in (the main stream waits on their copy) before its gather. A batch
is released after its landing is enqueued: ``emb_bwd`` after the callback
and the in-place landing, the deferred τ=1 landing through
``release_pending``, a skipped batch clean. The window's rows live in other
places than the full table's, and nothing in the step depends on where, so
a cached engine equals the uncached one bit for bit, capacity limited or
not. :meth:`GREngine.full_snapshot` (the vocab-sized state on the host)
and :meth:`GREngine.adopt_full_state` carry a cached run through
checkpoints in the uncached layout.
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
from repro_torch.data.freq import ID_FEATURES
from repro_torch.embedding.cache import CachedShadowedTable, CacheThrash
from repro_torch.embedding.tables import ShadowedTable
from repro_torch.models import gr as GR
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

#: Stages that issue collectives over a sharded table (``hsp``): a retry
#: on one rank alone would break the order the ranks issue them in, so
#: none of them is retried in place.
COLLECTIVE_STAGES = ("emb_fwd", "dense_fwd", "dense_bwd", "emb_bwd")


def _step_fns(bundle, loss_kwargs: Optional[Dict[str, Any]], hsp=None):
    """(the loss with ``loss_kwargs`` bound, the input gather and label
    lookup of its ``lookup_fn`` (None: the plain gather) as the stages'
    keyword arguments): one rule for the flat step and the engine, so they
    never disagree on the dataflow. ``hsp``: bound in the loss, and its
    exchange is the lookup."""
    lk = dict(loss_kwargs or {})
    if hsp is not None:
        if lk.get("lookup_fn") is not None:
            raise ValueError("the HSP exchange is the lookup over a sharded "
                             "table; a lookup_fn cannot be bound beside it")
        lk["hsp"] = hsp
        lk["lookup_fn"] = lambda t, ids: hsp.gather(t, ids)
    lookup_fn = lk.get("lookup_fn")
    return (lambda d, t, b, **kw: bundle.loss(d, t, b, **lk, **kw),
            dict(input_gather=lambda t, b: bundle.input_gather(
                t, b, lookup_fn=lookup_fn), lookup_fn=lookup_fn))


def make_gr_step_fn(bundle, *, loss_kwargs: Optional[Dict[str, Any]] = None,
                    lr_dense: float = 4e-3, lr_sparse: float = 4e-3,
                    semi_async: bool = True, hsp=None):
    """The engine's flat train step as a standalone ``(state, batch) ->
    (state, metrics)`` function: what ``GREngine(schedule="flat")``
    computes, and what both schedules are bit-identical to. With ``hsp``
    the state is this rank's and the batch its pack (:func:`rank_pack`)."""
    loss_fn, fns = _step_fns(bundle, loss_kwargs, hsp)
    return make_gr_train_step(loss_fn, **fns, lr_dense=lr_dense,
                              lr_sparse=lr_sparse, semi_async=semi_async,
                              hsp=hsp)


#: Batch entries of the whole global batch, which every rank keeps whole:
#: its key, and the §4.3.3 sharing perms a caller may give (the global
#: (n_seg, expansion − 1, segment) ones, ``GRBundle.loss``)
WHOLE_BATCH_KEYS = ("rng", "share_perms")


def rank_pack(batch: Dict[str, Any], rank: int) -> Dict[str, Any]:
    """Pack ``rank`` of a global (G, ...) loader batch, as a (1, ...)
    batch (the entries of ``WHOLE_BATCH_KEYS`` stay whole)."""
    return {k: (v if k in WHOLE_BATCH_KEYS else v[rank:rank + 1])
            for k, v in batch.items()}


def hsp_train_state(bundle, hsp, gen: torch.Generator, device,
                    qdtype=torch.float16) -> GRTrainState:
    """This rank's initial state over a sharded table: the dense params
    drawn from ``gen`` as the single-process engine draws them, and only
    the master's rows [lo, hi), the same bits as the single process's
    (``GRBundle.init_table(rows=...)`` draws by row block)."""
    dense = bundle.init_dense(gen, device=device)
    rows = hsp.shard_range(bundle.cfg.vocab_size)
    return gr_train_state(dense, bundle.init_table(gen, device=device,
                                                   rows=rows),
                          qdtype=qdtype)


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
        rows in dense_fwd. A batch may carry its §4.3.3 sharing perms as
        ``"share_perms"`` (the tests inject the reference's that way);
        else the loss draws them from the batch's ``rng``.
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
    cache: a :class:`~repro_torch.embedding.cache.CachedShadowedTable`
        (warmed up): the engine trains its window, on the cache's device (a
        given state's table must be the window). Records gain ``"cache"``
        (the step's hits, misses, chunks loaded and evicted, swap bytes),
        obs ``cache_step`` and ``cache``; checkpoints hold
        :meth:`full_snapshot`. A ``lookup_fn`` cannot be combined with it.
    hsp: an :class:`~repro_torch.core.hsp.HSPLookup` (hierarchical sparse
        parallelism, paper §4.2.1) over this rank's mesh: the state's table
        is the rank's shard (default: its rows of the table the
        single-process engine draws, drawn alone, :func:`hsp_train_state`),
        the data give the
        global (G = world, cap) batches and each step trains pack ``rank``
        (every rank builds the same loader from the same seed); lookups,
        negatives and table grads go through the exchange, the loss and
        the dense grads are summed over all ranks, and records carry the
        global loss. With ``expansion`` > 1 in ``loss_kwargs`` the
        sharing pool is the global batch's, bit for bit the single process
        at a world of one (``HSPLookup.share_tokens``). The collectives
        are issued from the device stages on
        the main thread, so the ranks issue them in one order; a stage
        that issues one is not retried in place (dense_bwd is no longer
        retry-safe), and :meth:`run_resilient` ends on any failure, which
        the elastic supervisor recovers from (``training/elastic.py``).
        Checkpoints are the full-table layout, each owner writing its rows
        (:func:`~repro_torch.training.checkpoint.save_sharded`). Not with
        a ``cache`` (as the reference).

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
                 device: DeviceLike = None,
                 cache: Optional[CachedShadowedTable] = None,
                 fault_policy: Optional[R.FaultPolicy] = None,
                 fault_injector: Optional[R.FaultInjector] = None,
                 obs: Optional[Obs] = None,
                 peak_flops: Optional[float] = None, hsp=None):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}")
        if cache is not None and hsp is not None:
            raise ValueError("the embedding cache translates ids to window "
                             "rows on the host; the HSP exchange expects "
                             "global ids — the two cannot be combined")
        if hsp is not None and \
                hsp.compute_dtype != GR.torch_dtype(bundle.cfg.dtype):
            raise ValueError(f"the HSP lookup computes in "
                             f"{hsp.compute_dtype}, the model in "
                             f"{bundle.cfg.dtype}")
        if cache is not None and \
                dict(loss_kwargs or {}).get("lookup_fn") is not None:
            raise ValueError("the embedding cache translates ids to window "
                             "rows on the host; a custom lookup_fn expects "
                             "global ids — the two cannot be combined")
        if state is not None and device is not None:
            raise ValueError("pass a state or a device, not both: a given "
                             "state trains where it lies")
        if cache is not None:
            if device is not None and \
                    resolve_device(device) != cache.device:
                raise ValueError(f"device {device} is not the cache's "
                                 f"({cache.device})")
            window = cache.window or cache.init_window()
            if state is not None and state.table.master is not window.master:
                raise ValueError("a cached engine trains the cache's window: "
                                 "the given state's table is another one")
            device = cache.device
        if state is None and hsp is not None:
            dev = hsp.mesh.device if device is None else resolve_device(
                device)
            state = hsp_train_state(
                bundle, hsp, torch.Generator(device=dev).manual_seed(seed),
                dev, qdtype)
        if state is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            dense = bundle.init_dense(gen, device=dev)
            state = gr_train_state(
                dense, (window if cache is not None
                        else bundle.init_table(gen, device=dev)),
                qdtype=qdtype)
        self.cache = cache
        self.hsp = hsp
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
        loss_fn, fns = _step_fns(bundle, loss_kwargs, hsp)
        self.stages = make_gr_stages(loss_fn, **fns,
                                     lr_dense=lr_dense, lr_sparse=lr_sparse,
                                     semi_async=semi_async, hsp=hsp)
        self._retry_safe = (RETRY_SAFE_STAGES if hsp is None else
                            tuple(s for s in RETRY_SAFE_STAGES
                                  if s not in COLLECTIVE_STAGES))
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
                    retry_body=s in self._retry_safe)
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
        if self.cache is not None:
            self.cache.release_pending()

    def _maybe_land_leftover(self, i: int, stage: str):
        if not self._leftover:
            return
        if stage == "emb_fwd" and i == 0:
            return                      # batch 0's input read stays stale
        self._land_pending()
        self._leftover = False

    # -- Algorithm-1 hooks -------------------------------------------------
    def _hk_dataload(self, i: int):
        nb = self._batch(i)
        return nb if self.hsp is None else rank_pack(nb, self.hsp.rank)

    def _hk_a2a(self, i: int, nb):
        # under the cache the id features stay on the host: the unique
        # stage uploads them once translated to window rows
        dev, ev = self._upload(nb if self.cache is None else
                               {k: v for k, v in nb.items()
                                if k not in ID_FEATURES})
        return {"np": nb, "dev": dev, "events": [ev]}

    def _hk_unique(self, i: int, art):
        # without a cache: emb_bwd sorts the step's slots on the card
        if self.cache is None:
            return art
        return self._cache_prefetch(i, art)

    def _cache_prefetch(self, i: int, art):
        """The cache path of the unique stage (a worker thread): pin the
        batch's chunks, write dirty victims back and copy the missing
        chunks to the card (complete on return: the copies overlap the
        previous batches' device stages), then translate the id features
        to window rows and upload them with an event."""
        C, nb = self.cache, art["np"]
        keys = [k for k in ID_FEATURES if k in nb]
        plan, cstats = C.prepare_batch(i, [nb[k] for k in keys])
        dev, ev = self._upload({k: C.translate(nb[k]) for k in keys})
        return {**art, "dev": {**art["dev"], **dev},
                "events": art["events"] + [ev], "plan": plan,
                "cache": cstats}

    def _hk_emb_fwd(self, i: int, art):
        self._await_uploads(art)
        if self.cache is not None:
            # before the gather: every chunk this batch reads that a
            # prefetch (its own or a concurrent one) admitted lands here
            self.cache.splice(self.state.table, art.get("plan"))
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
        # over a sharded table: the loss and the dense grads of all ranks
        full["dout"] = self.stages.dense_reduce(full["dout"])
        loss = float(full["dout"].loss)   # realise the enqueued fwd+bwd
        tokens = int(np.asarray(full["np"]["offsets"])[:, -1].sum())
        rec = {"step": i, "loss": loss, "tokens": tokens}
        if self.cache is not None:
            rec["cache"] = full.get("cache")
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
            if self.cache is not None:
                self.cache.release(i, dirty=False)
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
        deferred = self.semi_async and (defer_sparse or i == self._run_last)
        if self.cache is not None and deferred:
            # the pairs stay pending: the chunks stay pinned until the
            # deferred landing (release_pending)
            self.cache.defer_release(i)
        if self.step_callback:
            self.step_callback(i, rec, self.state)
        if self.semi_async and not deferred:
            # pipelined steady state: land now, in place, after the
            # callback saw the carry — dense_fwd(i+1) is the next stage
            self._land_pending()
        if self.cache is not None and not deferred:
            # unpin only now: the landing is enqueued (the release records
            # the event a victim's writeback waits on), and the callback
            # may have saved the pre-landing state
            self.cache.release(i, dirty=True)
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
        if rec.get("cache"):
            mx.publish("cache_step", rec["cache"])

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
        if self.cache is not None:
            self._mx.publish("cache", self.cache.counters())

    # -- cache <-> full-table state -----------------------------------------
    def full_snapshot(self, state: Optional[GRTrainState] = None
                      ) -> CKPT.HostSnapshot:
        """The vocab-sized carry-convention state on the host (default: the
        engine's), as a :class:`~repro_torch.training.checkpoint.
        HostSnapshot`: with a cache, the host store overlaid with the
        window's dirty chunks and the τ=1 carry globalized (bit for bit the
        uncached engine's); without one, the state's host copy. It is the
        one form checkpoints store, so cached and uncached runs save
        interchangeably, and a save of it makes no second host copy of the
        table."""
        st = state if state is not None else self.state
        if self.cache is None:
            return CKPT.snapshot(st)
        table = self.cache.materialize()
        ids, rows = self.cache.globalize_pending_pairs(st.pending_ids,
                                                       st.pending_rows)
        return CKPT.snapshot(st._replace(table=table, pending_ids=ids,
                                         pending_rows=rows))

    def checkpoint_tree(self, state: Optional[GRTrainState] = None):
        """What a checkpoint of the carry-convention ``state`` (default:
        the engine's) saves: without a cache the state itself (a save
        copies it to the host); with one a :class:`~repro_torch.training.
        checkpoint.HostSnapshot` of the vocab-sized state, the τ=1 carry
        globalized, whose master and accumulator leaves stream from the
        cache's host store overlaid with the window's dirty chunks (no copy
        of the table; ``CachedShadowedTable.table_snapshot``). Its host copy
        is complete when this returns; a save consumes it (each table leaf
        is read once, and the save closes it)."""
        st = state if state is not None else self.state
        if self.cache is None:
            return st
        t0 = time.perf_counter()
        master, accum = self.cache.table_snapshot()
        try:
            ids, rows = self.cache.globalize_pending_pairs(st.pending_ids,
                                                           st.pending_rows)
            snap = CKPT.snapshot(st._replace(
                table=ShadowedTable(master, st.table.shadow, accum),
                pending_ids=ids, pending_rows=rows))
        except BaseException:
            master.close()
            accum.close()
            raise
        return snap._replace(seconds=time.perf_counter() - t0)

    def _full_layout(self, carry_rows: Optional[int] = None
                     ) -> GRTrainState:
        """The engine's state with a vocab-sized table of zero-strided
        arrays (and, with ``carry_rows``, a τ=1 carry of that many
        zero-strided rows): the full state's structure, copying nothing."""
        st = self.state
        if carry_rows is not None:
            d = st.pending_rows.shape[-1]
            st = st._replace(
                pending_ids=np.broadcast_to(np.int32(0), (carry_rows,)),
                pending_rows=np.broadcast_to(np.float32(0),
                                             (carry_rows, d)))
        if self.cache is None:
            return st
        z = np.broadcast_to(np.float32(0), (self.cache.vocab,
                                            self.cache.dim))
        return st._replace(table=ShadowedTable(z, st.table.shadow, z))

    def full_template(self) -> CKPT.HostSnapshot:
        """The leaf structure of :meth:`full_snapshot`, no arrays: the
        template a restore fills on the host before
        :meth:`adopt_full_state`."""
        return CKPT.host_template(self._full_layout())

    def adopt_full_state(self, full) -> GRTrainState:
        """Load a vocab-sized state (a :class:`HostSnapshot`, e.g. a
        restore into :meth:`full_template`, or a GRTrainState) into the
        engine: the dense params, moments, count and step into the state's
        tensors; with a cache the table into the host store (residency
        rebuilt from the LFU counters, the carry's chunks admitted and
        pinned, the window refilled in place) and the carry translated to
        window rows, ascending; without one, the table in place."""
        if not isinstance(full, CKPT.HostSnapshot):
            full = CKPT.snapshot(full)
        if self.cache is None:
            self.state = CKPT.load_snapshot(self.state, full)
            return self.state
        st = CKPT.load_snapshot(self.state, full, table=False)
        arr = dict(zip(full.paths, full.arrays))
        ids, rows = CKPT.compact_carry(arr["pending_ids"],
                                       arr["pending_rows"])
        window, slots = self.cache.adopt(
            ShadowedTable(arr["table.master"], None, arr["table.accum"]),
            ids)
        order = torch.from_numpy(np.argsort(slots, kind="stable"))
        self.state = st._replace(
            table=window,
            pending_ids=torch.from_numpy(slots)[order].to(self.device),
            pending_rows=CKPT.to_tensor(rows, self.device)[
                order.to(self.device)])
        return self.state

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
    def resilient_host_bytes(self, batch, keep_anchor: bool = True
                             ) -> Dict[str, int]:
        """The host memory a resilient run counts before its first step
        (see :meth:`run_resilient`), by what holds it: the saver's copy,
        with the τ=1 carry at its largest (a row per id feature entry of
        ``batch``, the run's first batch: every batch has its shape) and,
        for a card state, as the pinned-memory allocator holds it (each
        buffer rounded up to a power of two); the I/O buffers (a restore
        holds no leaf whole: its CRC pass and its reads go through them);
        the anchor as the state is now; a cache's host store."""
        ids = sum(int(np.asarray(batch[k]).size) for k in ID_FEATURES
                  if k in batch)
        vocab = (self.cache.vocab if self.cache is not None
                 else int(self.state.table.master.shape[0]))
        layout = self._full_layout(carry_rows=min(ids, vocab))
        if self.cache is not None:
            saver = CKPT.host_nbytes(layout._replace(table=ShadowedTable(
                *(None if t is None else t[:0] for t in layout.table)))
            ) + self.cache.window_nbytes
        else:
            saver = CKPT.host_nbytes(layout,
                                     pinned=self.device.type == "cuda")
        parts = [("the saver's copy", saver),
                 ("the checkpoint I/O buffers", CKPT.IO_BUFFER_BYTES)]
        if keep_anchor:
            parts.append(("the replay anchor until the first save is "
                          "written", CKPT.host_nbytes(self._full_layout())))
        if self.cache is not None:
            parts.append(("the cache's host store", self.cache.host_nbytes))
        return dict(parts)

    def _check_host_memory(self, batch, keep_anchor: bool) -> None:
        """Raise MemoryError unless the host's available memory holds the
        run's count besides what is held already (a cache's host store,
        resident since it was built)."""
        parts = self.resilient_host_bytes(batch, keep_anchor)
        need = sum(parts.values())
        held = 0 if self.cache is None else self.cache.host_nbytes
        avail = CKPT.host_available_bytes()
        if avail is not None and need - held > avail:
            raise MemoryError(
                f"run_resilient needs {need / 1e9:.2f} GB of host memory: "
                + ", ".join(f"{what} {n / 1e9:.2f} GB"
                            for what, n in parts.items())
                + f"; {avail / 1e9:.2f} GB available besides "
                f"{held / 1e9:.2f} GB held already")

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

    def _write_ckpt(self, saver, ckpt_dir: str, step_num: int, state,
                    keep_last_n) -> None:
        """One checkpoint inside a resilient run, of the carry-convention
        ``state`` (τ=1 pairs pending, table not landed), as
        :meth:`checkpoint_tree` gives it, taken once the save in flight has
        finished (one host copy at a time: the saver's buffers, or a
        cache's streamed view); its host copy is complete when this
        returns. A torn-save injection site for this step crashes the write
        as a real mid-save failure would (wreckage on disk, then the run
        fails): recovery must fall back to the previous intact step. Over a
        sharded table every rank takes part in a synchronous
        :func:`~repro_torch.training.checkpoint.save_sharded` (no torn-save
        injection there)."""
        if self.hsp is not None:
            t0 = time.perf_counter()
            CKPT.save_sharded(ckpt_dir, step_num, state, self.hsp,
                              keep_last_n=keep_last_n, registry=self._mx)
            self.snapshots.append((step_num, time.perf_counter() - t0, 0))
            return
        spec = (self._injector.take(R.SAVE_SITE, step_num)
                if self._injector else None)
        torn = spec is not None and spec.kind == "torn_save"
        if saver is not None:
            try:
                saver.wait()              # serialize with in-flight save
            except Exception:
                if not torn:
                    raise
        tree = self.checkpoint_tree(state)
        if torn:
            snap = saver.copy(tree) if saver is not None else \
                CKPT.snapshot(tree)
            self.snapshots.append((step_num, snap.seconds, snap.nbytes))
            self.fault_events.append(("torn_save", R.SAVE_SITE, step_num))
            try:
                R.simulate_torn_save(ckpt_dir, step_num, snap,
                                     tear=spec.tear)
            finally:
                CKPT.release(snap)
            raise R.InjectedFault(
                f"crash mid-save of step {step_num} ({spec.tear})")
        if saver is not None:
            saver.save_async(step_num, tree)
            self.snapshots.append(saver.snapshots[-1])
        else:
            snap = CKPT.snapshot(tree)
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
        host copy until the run's first save has been written, if none
        exists yet) and the remaining steps replay.
        Checkpoints hold the carry-convention state, so a failed-and-
        recovered run is bit-identical to an uninterrupted one in both
        schedules, sync and τ=1.

        Returns the per-step records for global steps ``[start, steps)`` in
        order (``start`` defaults to ``state.step``; a record replayed
        after a recovery overwrites its first, identical, incarnation).
        ``fault_events`` collects typed ``(kind, stage, step)`` events,
        ``recoveries`` one :class:`RecoveryEvent` per restore cycle and
        ``snapshots`` each checkpoint's host copy (step, seconds, bytes).

        With a cache, checkpoints stream the table from the host store
        (:meth:`checkpoint_tree`), the anchor is a :meth:`full_snapshot`,
        and a restore reads into :meth:`full_template`, then
        :meth:`adopt_full_state` streams the table into the host store; a
        :class:`CacheThrash` is raised at once (a replay would thrash
        again).

        Before its first step the run checks that the host holds what it
        will hold besides the state (:meth:`resilient_host_bytes`): the
        saver's copy (the whole state; with a cache all but the table, plus
        at most the window's rows), the checkpoint I/O buffers (a restore
        streams every leaf), the anchor while it lives, and a cache's host
        store (held already). It raises :class:`MemoryError` if the host
        does not.

        Over a sharded table (``hsp``) the saves are every rank's
        synchronous :func:`~repro_torch.training.checkpoint.save_sharded`,
        there is no anchor and no host-memory count (a rank's save holds a
        piece at a time), and any failure ends the run on this rank: its
        peers' collectives fail within the mesh's timeout, and the elastic
        supervisor restarts the world from the newest intact checkpoint
        (:class:`~repro_torch.training.elastic.ElasticRunner`).
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
        # complete. For the same reason the anchor is dropped once this
        # run's first save has been written.
        sharded = self.hsp is not None
        keep_anchor = not sharded and not any(
            s >= base0 for s in CKPT.intact_steps(ckpt_dir))
        if not sharded:
            self._check_host_memory(fetch(base0), keep_anchor)
        saver = (CKPT.AsyncCheckpointer(ckpt_dir, keep_last_n=keep_last_n,
                                        registry=self._mx)
                 if async_save and not sharded else None)
        initial = self.full_snapshot() if keep_anchor else None
        saved_sync = []                   # steps a synchronous save wrote

        def drop_anchor_once_saved() -> None:
            nonlocal initial
            if saved_sync or (saver is not None and saver.completed):
                initial = None

        def on_step(i: int, rec: Dict[str, Any], snapshot) -> None:
            g = self._resume_base + i
            grec = dict(rec, step=g)
            records[g] = grec
            if prev_cb:
                prev_cb(g, grec, snapshot)
            done = g + 1
            drop_anchor_once_saved()
            if (ckpt_every and done % ckpt_every == 0) or \
                    (final_save and done == steps):
                self._write_ckpt(saver, ckpt_dir, done, snapshot,
                                 keep_last_n)
                if saver is None:
                    saved_sync.append(done)

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
                    if isinstance(err, CacheThrash) or sharded:
                        raise
                    t0 = time.perf_counter()
                    if saver is not None:
                        try:
                            saver.wait()   # surface/serialize async saves
                        except Exception:
                            pass           # a torn async save is recovered
                    drop_anchor_once_saved()
                    if len(self.recoveries) >= pol.max_recoveries:
                        raise
                    failed = max(records, default=base - 1) + 1
                    if self.cache is not None:
                        self.cache.reset_pins()   # the failed run's pins
                    try:
                        if self.cache is None:
                            self.state, used = CKPT.restore_with_step(
                                ckpt_dir, self.state, registry=self._mx)
                        else:
                            full, used = CKPT.restore_with_step(
                                ckpt_dir, self.full_template(),
                                registry=self._mx)
                            self.adopt_full_state(full)
                            del full
                    except (FileNotFoundError, CKPT.CheckpointCorrupt):
                        if initial is None:
                            raise     # the start's intact steps are gone
                        # no intact checkpoint yet: replay from the anchor
                        self.adopt_full_state(initial)
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


    def restore_latest(self, ckpt_dir: str, step: Optional[int] = None
                       ) -> Optional[int]:
        """Restore the newest intact checkpoint under ``ckpt_dir`` (or
        ``step``) into the engine's state (uncached); the step restored, or
        None when the directory holds none. Over a sharded table every rank
        calls it (:func:`~repro_torch.training.checkpoint.restore_sharded`:
        each reads its own rows)."""
        try:
            if self.hsp is not None:
                self.state, used = CKPT.restore_sharded(
                    ckpt_dir, self.state, self.hsp, step=step,
                    registry=self._mx)
            else:
                self.state, used = CKPT.restore_with_step(
                    ckpt_dir, self.state, step=step, registry=self._mx)
        except FileNotFoundError:
            return None
        return used

    # -- reporting ---------------------------------------------------------
    def timeline_report(self) -> Dict[str, Any]:
        """Table-6 breakdown of the last run's real stage events."""
        return _timeline_report(self.events)
