"""Elastic scaling + straggler tolerance (the port of
``repro.training.elastic``).

On a cluster a node failure surfaces as a collective that fails; recovery
is (1) rebuild the mesh from the surviving ranks, (2) restore the latest
*intact* checkpoint resharded onto the new mesh, (3) recompute the data
partition for the new world size. :func:`viable_mesh_shape`,
:func:`rebuild_mesh` and :func:`reshard` are those steps;
:class:`ElasticRunner` drives them as a **supervisor process**: for each
segment it starts the world's rank processes
(:func:`~repro_torch.launch.mesh.spawn_ranks`), each building its engine
over the mesh, restoring the newest intact checkpoint (its own rows of it,
:meth:`~repro_torch.training.engine.GREngine.restore_latest`) and running
``run_resilient`` to the segment's end. A rank that fails ends its process;
its peers' collectives then fail within the mesh's timeout and end theirs;
the supervisor waits for every rank (ending any that outlive the
segment's deadline), shrinks the world to :func:`viable_mesh_shape` of the
survivors and starts the next segment. The reference recovers in one
controller process; here the processes are the unit that fails and is
restarted (a declared divergence).

The ``model`` degree is kept and ``data`` shrinks, as the reference keeps
shard owners (embedding rows must not change owners mid-run: a rank of the
new world reads the same row range it owned before).

Straggler mitigation is the §4.1.3 load balancer plus the per-step
watchdog: steps slower than ``step_timeout_s`` are recorded as typed
``("straggler", step)`` events, unambiguous at step 0.
"""
from __future__ import annotations

import copy
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.hsp import carry_span
from repro_torch.embedding.tables import ShadowedTable
from repro_torch.launch import mesh as M
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.trainer import GRTrainState


def viable_mesh_shape(num_devices: int, model_parallel: int
                      ) -> Tuple[int, int]:
    """Largest (data, model) grid using ≤ num_devices ranks, preserving
    the model-parallel degree (shrinking data-parallel width instead —
    embedding shards must not change owners mid-run)."""
    model = math.gcd(model_parallel, num_devices)
    while model > 1 and num_devices // model < 1:
        model //= 2
    data = num_devices // model
    return max(data, 1), max(model, 1)


def rebuild_mesh(num_ranks: int, model_parallel: int, *, rank: int,
                 **mesh_kwargs) -> M.Mesh:
    """This rank's mesh over the first ``prod(viable_mesh_shape(num_ranks,
    model_parallel))`` of ``num_ranks`` surviving ranks (``mesh_kwargs``:
    :func:`~repro_torch.launch.mesh.make_mesh`'s store, timeout, device
    and backend)."""
    return M.make_mesh(viable_mesh_shape(num_ranks, model_parallel),
                       M.AXES, rank=rank, **mesh_kwargs)


@torch.no_grad()
def reshard(state: GRTrainState, hsp) -> GRTrainState:
    """This rank's part of a full (vocab-sized) state, on the mesh's
    device: the dense params and moments as they are, the rows [lo, hi)
    of the master, shadow and accumulator, and the τ=1 carry's pairs of
    those rows (shard-relative ids; the carry's ids ascend, as the train
    step leaves them). A new state; ``state`` is not changed."""
    dev = hsp.mesh.device
    tbl = state.table
    lo, hi = hsp.shard_range(tbl.master.shape[0])
    rows = lambda t: (None if t is None                     # noqa: E731
                      else t[lo:hi].to(dev, copy=True))
    a, b = carry_span(state.pending_ids, lo, hi)
    dense = copy.deepcopy(state.dense).to(dev)
    opt = state.dense_opt
    return GRTrainState(
        dense=dense,
        dense_opt=opt._replace(
            mu={k: v.to(dev, copy=True) for k, v in opt.mu.items()},
            nu={k: v.to(dev, copy=True) for k, v in opt.nu.items()}),
        table=ShadowedTable(rows(tbl.master), rows(tbl.shadow),
                            rows(tbl.accum)),
        pending_ids=(state.pending_ids[a:b] - lo).to(dev, torch.int32),
        pending_rows=state.pending_rows[a:b].to(dev, copy=True),
        step=state.step)


def _import(path: str) -> Callable:
    import importlib
    mod, fn = path.split(":")
    return getattr(importlib.import_module(mod), fn)


def run_segment(mesh: M.Mesh, *, build: str, build_kwargs: Dict[str, Any],
                ckpt_dir: str, num_steps: int, ckpt_every: int,
                keep_last_n: Optional[int], final_save: bool,
                step_timeout_s: float, records_path: str,
                fail_step: Optional[int] = None, drop: int = 0
                ) -> Dict[str, Any]:
    """One rank of one segment (run by :class:`ElasticRunner` through
    :func:`~repro_torch.launch.mesh.spawn_ranks`): build the engine
    (``build(mesh, **build_kwargs)``), restore the newest intact
    checkpoint, and ``run_resilient`` to ``num_steps``. Rank 0 appends a
    JSON line per step (and per straggler) to ``records_path``. With
    ``fail_step``, the last ``drop`` ranks exit when that step begins (a
    node lost), and the others fail in their next collective with them."""
    t0 = time.perf_counter()
    engine = _import(build)(mesh, **build_kwargs)
    t1 = time.perf_counter()
    start = engine.restore_latest(ckpt_dir) or 0
    t2 = time.perf_counter()
    last = {"t": time.perf_counter()}
    out = open(records_path, "a") if mesh.rank == 0 else None
    dropping = fail_step is not None and mesh.rank >= mesh.world - drop

    def on_step(g: int, rec: Dict[str, Any], state) -> None:
        now = time.perf_counter()
        if out is not None:
            if step_timeout_s and now - last["t"] > step_timeout_s:
                out.write(json.dumps({"event": "straggler", "step": g})
                          + "\n")
            out.write(json.dumps({"step": g, "loss": rec["loss"],
                                  "tokens": rec["tokens"],
                                  "world": mesh.world, "t": time.time()})
                      + "\n")
            out.flush()
        last["t"] = now
        if dropping and g + 1 == fail_step:
            sys.stdout.flush()
            os._exit(0)

    engine.step_callback = on_step
    try:
        engine.run_resilient(num_steps, ckpt_dir=ckpt_dir,
                             ckpt_every=ckpt_every, keep_last_n=keep_last_n,
                             final_save=final_save, start_step=start)
    finally:
        if out is not None:
            out.close()
    return {"start": start, "end": num_steps, "build_s": t1 - t0,
            "restore_s": t2 - t1, "run_s": time.perf_counter() - t2,
            "saves": [list(x) for x in engine.snapshots],
            "stats": mesh.stats}


@dataclass
class ElasticRunner:
    """Supervised GR training over a world of rank processes with
    checkpoint/restart and elastic shrink.

    build_engine: ``"module:function"``, called in each rank process as
        ``fn(mesh, **build_kwargs) -> GREngine``: an engine over the mesh
        (an ``hsp`` lookup on it, the data's global batches of
        ``mesh.world`` packs for the global step the engine asks for).
    ckpt_dir: where the segments save and restore (full-table layout).
    model_parallel: the ``model`` degree, kept across shrinks.
    device, mesh_timeout_s: the ranks' mesh (gloo;
        :func:`~repro_torch.launch.mesh.make_mesh`).
    step_timeout_s: straggler watchdog (0 = off).
    segment_deadline_s: how long a segment may run before the supervisor
        ends its ranks.
    events: typed ``(kind, step)`` records — ``("node_failure", t)``,
        ``("straggler", t)``, ``("recovery", t)`` (the step restored).
    records: rank 0's per-step records, a replayed step's last.
    """
    build_engine: str
    ckpt_dir: str
    build_kwargs: Dict[str, Any] = field(default_factory=dict)
    model_parallel: int = 1
    ckpt_every: int = 10
    step_timeout_s: float = 0.0
    keep_last_n: Optional[int] = None
    device: str = "cuda"
    mesh_timeout_s: float = 60.0
    segment_deadline_s: float = 1800.0
    run_dir: Optional[str] = None

    events: List[Tuple[str, int]] = field(default_factory=list)
    records: List[Dict[str, Any]] = field(default_factory=list)
    segments: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def failures(self) -> List[int]:
        """Steps with node failures (typed view of events)."""
        return [t for k, t in self.events if k == "node_failure"]

    def run(self, num_steps: int, world: int,
            fail_at: Optional[Dict[int, int]] = None) -> Optional[int]:
        """Train to ``num_steps`` on ``world`` ranks, from the newest intact
        checkpoint under ``ckpt_dir`` (step 0 without one); ``fail_at:
        {step: ranks_to_drop}`` makes that many ranks exit when the step
        begins (recovery goes through the checkpoint, resharded onto the
        shrunk mesh). Saves every ``ckpt_every`` steps and after the last;
        returns the last saved step."""
        fail_at = dict(fail_at or {})
        run_dir = self.run_dir or os.path.join(self.ckpt_dir, "_ranks")
        records: Dict[int, Dict[str, Any]] = {r["step"]: r
                                              for r in self.records}
        t = CKPT.latest_step(self.ckpt_dir) or 0
        while t < num_steps:
            data, model = viable_mesh_shape(world, self.model_parallel)
            w = data * model
            fails = sorted(s for s in fail_at if t < s < num_steps)
            fail = fails[0] if fails else None
            drop = fail_at.pop(fail) if fail is not None else 0
            seg_dir = os.path.join(run_dir, f"seg{len(self.segments)}")
            os.makedirs(seg_dir, exist_ok=True)
            rec_path = os.path.join(seg_dir, "records.jsonl")
            kwargs = dict(build=self.build_engine,
                          build_kwargs=self.build_kwargs,
                          ckpt_dir=self.ckpt_dir, num_steps=num_steps,
                          ckpt_every=self.ckpt_every,
                          keep_last_n=self.keep_last_n, final_save=True,
                          step_timeout_s=self.step_timeout_s,
                          records_path=rec_path, fail_step=fail, drop=drop)
            t0 = time.perf_counter()
            procs = M.spawn_ranks(
                "repro_torch.training.elastic:run_segment", kwargs,
                shape=(data, model), run_dir=seg_dir, device=self.device,
                timeout_s=self.mesh_timeout_s)
            rcs = M.wait_ranks(procs, self.segment_deadline_s)
            seg = dict(world=w, shape=(data, model), start=t, fail=fail,
                       drop=drop, rcs=rcs, wall_s=time.perf_counter() - t0,
                       ended=time.time(),
                       results=M.rank_results(seg_dir, w))
            self.segments.append(seg)
            if os.path.exists(rec_path):
                for line in open(rec_path):
                    r = json.loads(line)
                    if "event" in r:
                        self.events.append((r["event"], r["step"]))
                    else:
                        records[r["step"]] = r
            if fail is None:
                if any(rcs):
                    logs = M.rank_logs(seg_dir, w)
                    raise RuntimeError(
                        f"segment from step {t} on {w} ranks failed "
                        f"(exit codes {rcs}):\n"
                        + "\n".join(lg[-2000:] for lg in logs if lg))
                t = num_steps
                continue
            self.events.append(("node_failure", fail))
            world = w - drop
            t = CKPT.latest_step(self.ckpt_dir) or 0
            self.events.append(("recovery", t))
            for g in [g for g in records if g >= t]:
                del records[g]
        self.records = [records[g] for g in sorted(records)]
        return CKPT.latest_step(self.ckpt_dir)


def build_gr_engine(mesh: M.Mesh, *, arch: str, data: Dict[str, Any],
                    overrides: Optional[Dict[str, Any]] = None,
                    reduce: bool = False, seed: int = 0,
                    schedule: str = "algorithm1", semi_async: bool = True,
                    loss_kwargs: Optional[Dict[str, Any]] = None,
                    group_axes: Sequence[str] = ("model",),
                    dp_axes: Sequence[str] = ("data",)):
    """A GR engine over ``mesh`` from JSON-able settings (an
    :class:`ElasticRunner`'s ``build_engine``): ``arch`` (``reduce``: its
    reduced form) with ``overrides``; the HSP lookup over ``group_axes``
    and ``dp_axes``; a ``GRLoader`` of ``mesh.world`` packs over synthetic
    KuaiRand (``data``: users, mean_len, sigma_len, max_len,
    users_per_device, max_seq_len, seed); the state drawn from ``seed``."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.hsp import make_hsp_lookup
    from repro_torch.data import GRLoader, SyntheticKuaiRand
    from repro_torch.models.gr import torch_dtype
    from repro_torch.models.model_zoo import GRBundle
    from repro_torch.training.engine import GREngine
    cfg = get_arch(arch)
    cfg = (reduced(cfg) if reduce else cfg).replace(**(overrides or {}))
    V = cfg.vocab_size
    gen = SyntheticKuaiRand(num_users=data["users"], num_items=V,
                            mean_len=data["mean_len"],
                            sigma_len=data.get("sigma_len", 0.6),
                            max_len=data["max_len"], seed=data["seed"])
    seqs = {u: (s["item"], s["ts"]) for u, s in
            ((u, gen.interactions(u)) for u in range(data["users"]))}
    loader = GRLoader(seqs, num_devices=mesh.world,
                      users_per_device=data["users_per_device"],
                      max_seq_len=data["max_seq_len"],
                      num_negatives=cfg.num_negatives, num_items=V,
                      seed=data["seed"])
    hsp = make_hsp_lookup(mesh, group_axes=tuple(group_axes),
                          dp_axes=tuple(dp_axes),
                          compute_dtype=torch_dtype(cfg.dtype))
    return GREngine(GRBundle(cfg), loader, seed=seed, hsp=hsp,
                    schedule=schedule, semi_async=semi_async,
                    loss_kwargs=loss_kwargs)
