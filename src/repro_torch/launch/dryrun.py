"""The dry-run: every (arch × shape × mesh) cell built on the ``meta``
device over the production mesh, one step counted per device (the port
of ``repro.launch.dryrun``).

For each cell this makes the production mesh over a one-process world of
256 (512) ranks on the ``fake`` backend (``launch.mesh.init_fake_world``:
the counterpart of the reference's 512 forced host devices), the plan
(``launch/partition.py``), the state and inputs on ``meta`` with the
plan's placements, and runs the train / prefill / decode step once under
``launch/op_analysis.OpAnalysis``: nothing is allocated anywhere. The
record holds the state bytes one device holds (from the placements), one
device's FLOPs, bytes and collective bytes by kind, and the roofline
terms (``launch/roofline.py``).

LM cells run the port's LM as DTensors (``partition.shard_model``) under
``core.sharding.shard_ctx(mesh, plan.rules)``. GR cells replicate the
dense model and run one device's pack (``gr_capacity``) as plain ``meta``
tensors through the port's kernels (their meta paths: K1-fwd, K2, K9, K6
with the reference's ``neg_mode="segmented"``), the table one device's
shard. Data-dependent sizes go to their upper bound, and the record's
``worst_case`` says which: the attention's work list at its capacity
(every row full length), the unique table-grad pairs u = n (every id
distinct), AdaGrad's landing over them, and the HSP exchange's ids and
rows. The port's HSP runs over its own gloo ``Mesh``, one process a rank,
which a one-process fake world cannot host: its collectives are counted
from the batch's shapes (``_hsp_worst_case``), not run.

Usage (no card needed: the fake mesh lives on the CPU):
    python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
        --shape train_4k --mesh single --device cpu
    python -m repro_torch.launch.dryrun --all --mesh both --device cpu \\
        --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES_BY_NAME, ShapeConfig, cells_for
from repro_torch.core.sharding import axes_size, shard_ctx
from repro_torch.launch import mesh as MS
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import partition as PT
from repro_torch.launch import roofline as RL
from repro_torch.models.model_zoo import get_bundle

META = torch.device("meta")

#: A state tensor of a cell: (name, global shape, dtype, spec).
Entry = Tuple[str, Tuple[int, ...], torch.dtype, PT.Spec]


class Cell(NamedTuple):
    """A built cell: ``step()`` runs one step on ``meta``; ``state`` lists
    every state tensor with its spec (its per-device bytes are the
    record's); ``worst_case`` names the data-dependent sizes taken at
    their bound; ``collectives`` are ones counted from shapes, not run
    (``[name, kind, operand bytes]``)."""
    cfg: ArchConfig
    shape: ShapeConfig
    plan: PT.Plan
    mesh: Any
    step: Callable[[], Any]
    state: List[Entry]
    worst_case: List[str]
    collectives: List[Tuple[str, str, int]]
    extra: Dict[str, Any]


def _sharded_bytes(entries: List[Entry], mesh) -> int:
    """Per-device bytes of the state: each tensor's bytes over the product
    of its spec's axis sizes."""
    return sum(PT.spec_bytes(shape, dtype, spec, mesh)
               for _, shape, dtype, spec in entries)


def local_state_bytes(cell: Cell) -> int:
    """A cell's state bytes on this rank as DTensor itself lays them out:
    each state tensor distributed on ``meta`` by its spec, its local
    shard's bytes summed (the check of :func:`_sharded_bytes`)."""
    return sum(_distribute(torch.empty(shape, dtype=dt, device=META),
                           cell.mesh, spec).to_local().numel()
               * torch.empty((), dtype=dt).element_size()
               for _, shape, dt, spec in cell.state)


def _distribute(x: torch.Tensor, mesh, spec: PT.Spec) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, PT.to_placements(mesh, spec))


@contextlib.contextmanager
def _sharded(mesh, plan: PT.Plan):
    """The plan's rules, and plain tensors the model makes inside (an
    arange, a zero) taken as replicated beside DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    with shard_ctx(mesh, plan.rules), implicit_replication():
        yield


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------

def _lm_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, plan: PT.Plan,
             device) -> Cell:
    from repro_torch.core.sharding import register_dtensor_rules
    from repro_torch.models.gr import torch_dtype
    from repro_torch.training.trainer import (lm_train_state,
                                              make_lm_train_step)
    register_dtensor_rules()
    bundle = get_bundle(cfg)
    model = bundle.init(device=device)
    pspecs = PT.lm_param_specs(model, mesh, plan)
    PT.shard_model(model, mesh, plan, pspecs)
    state: List[Entry] = [(n, tuple(p.shape), p.dtype, pspecs[n])
                          for n, p in model.named_parameters()]
    inputs = bundle.input_specs(shape)
    ispecs = PT.batch_specs(cfg, shape, mesh, plan, inputs)
    extra: Dict[str, Any] = {}

    if shape.kind == "train":
        opt_dtype = torch_dtype(plan.opt_dtype)
        st = lm_train_state(model, opt_dtype)
        opt = PT.state_specs(pspecs, mesh)["opt"]
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        state += [(f"opt.{mom}.{n}", shapes[n], opt_dtype, spec)
                  for mom in ("mu", "nu") for n, spec in opt[mom].items()]
        batch = {k: _distribute(v, mesh, ispecs["batch"][k])
                 for k, v in inputs["batch"].items()}
        step = make_lm_train_step(
            lambda m, b: bundle.loss(m, b, q_block=plan.q_block,
                                     remat=plan.remat),
            num_microbatches=plan.num_microbatches,
            accum_dtype=torch_dtype(plan.accum_dtype))

        def run():
            with _sharded(mesh, plan):
                return step(st, batch)[1]["loss"]
        return Cell(cfg, shape, plan, mesh, run, state, [], [], extra)

    if shape.kind == "prefill":
        batch = {k: _distribute(v, mesh, ispecs["batch"][k])
                 for k, v in inputs["batch"].items()}

        def run():
            with torch.no_grad(), _sharded(mesh, plan):
                return bundle.prefill(model, batch, q_block=plan.q_block)
        return Cell(cfg, shape, plan, mesh, run, state, [], [], extra)

    # decode: one new token against a cache of seq_len positions; the
    # cache is state (a serving deployment holds it), the token an input
    cache = inputs["cache"]
    cspecs = ispecs["cache"]
    for i, (k, v) in cache.kv.items():
        cache.kv[i] = tuple(_distribute(t, mesh, s)
                            for t, s in zip((k, v), cspecs["kv"][i]))
        state += [(f"cache.kv.{i}.{j}", tuple(t.shape), t.dtype, s)
                  for j, (t, s) in enumerate(zip((k, v), cspecs["kv"][i]))]
    for i, st_ in cache.ssm.items():
        for key, t in list(st_.items()):
            s = cspecs["ssm"][i][key]
            state.append((f"cache.ssm.{i}.{key}", tuple(t.shape), t.dtype, s))
            st_[key] = _distribute(t, mesh, s)
    token = _distribute(inputs["token"], mesh, ispecs["token"])
    embeds = (_distribute(inputs["embeds"], mesh, ispecs["embeds"])
              if "embeds" in inputs else None)
    cache_index = shape.seq_len - 1

    def run():
        with torch.no_grad(), _sharded(mesh, plan):
            return bundle.decode(model, token, cache, cache_index,
                                 embeds=embeds)
    return Cell(cfg, shape, plan, mesh, run, state, [], [],
                {"cache_index": cache_index})


# --------------------------------------------------------------------------
# GR cells
# --------------------------------------------------------------------------

def _hsp_worst_case(cfg: ArchConfig, plan: PT.Plan, mesh, pack: Dict,
                    dense_bytes: int) -> List[Tuple[str, str, int]]:
    """One device's HSP collectives of a step at the worst case, every id
    of its pack distinct (the port's exchange, ``core/hsp.py``): its ids
    to their owners and their rows back (inputs and labels in the compute
    dtype, negatives fp16), the unique grad pairs to their owners (ids and
    rows at the wire dtype), the owner's pairs gathered over the data
    replicas, and the dense grads and the loss summed over all ranks."""
    from repro_torch.models.gr import torch_dtype
    if mesh.size() == 1:
        return []                      # a world of one exchanges nothing
    d = cfg.d_model
    n_in = pack["ids"].numel() + pack["labels"].numel()
    n_neg = pack["neg_ids"].numel()
    n = n_in + n_neg
    cdt = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    wire = torch.empty((), dtype=torch_dtype(plan.grad_wire_dtype)
                       ).element_size()
    out = [("hsp.lookup", "all-to-all", n_in * 4 + n_in * d * cdt),
           ("hsp.negatives", "all-to-all", n_neg * 4 + n_neg * d * 2),
           ("hsp.grads", "all-to-all", n * (4 + d * wire))]
    if plan.hsp and axes_size(mesh, PT._dp_axes(mesh)) > 1:
        out.append(("hsp.replicas", "all-gather", n * (4 + d * 4)))
    out.append(("hsp.dense", "all-reduce", dense_bytes + 4))
    return out


def _gr_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, plan: PT.Plan,
             device) -> Cell:
    from repro_torch.kernels.jagged_attention import make_attn_fn
    from repro_torch.training import gr_train_state, make_gr_step_fn
    from repro_torch.training.trainer import gr_pending_slots
    if plan.neg_expansion > 1:
        # §4.3.3: fetch R/k negatives, recover the full set by sharing
        cfg = cfg.replace(num_negatives=cfg.num_negatives
                          // plan.neg_expansion)
    bundle = get_bundle(cfg)
    num_shards = (mesh.size() if plan.gr_layout == "pack"
                  else shape.global_batch)
    inputs = bundle.input_specs(shape, num_shards=num_shards)
    g = inputs["batch"]
    per_dev = g["ids"].shape[0] // mesh.size()
    if per_dev < 1:
        raise ValueError(f"{g['ids'].shape[0]} packs over {mesh.size()} "
                         f"devices")
    pack = {k: (v if k == "rng" else v[:per_dev]) for k, v in g.items()}
    n_pend = gr_pending_slots(g)
    V, d = cfg.vocab_size, cfg.d_model
    tspec = PT._guard(mesh, (V, d), PT.gr_table_spec(mesh, plan))
    rows = V // axes_size(mesh, tspec[0])
    dense = bundle.init_dense(device=device)
    dspecs = PT.gr_param_specs(dense, mesh, plan)
    table = torch.empty((rows, d), dtype=torch.float32, device=device)
    st = gr_train_state(dense, table, torch.float32)
    pend_spec = PT.gr_pend_spec(mesh, n_pend)
    sspecs = PT.gr_state_specs(dspecs, tspec, pend_spec=pend_spec)
    state: List[Entry] = []
    for n, p in dense.named_parameters():
        state.append((n, tuple(p.shape), p.dtype, dspecs[n]))
        for mom in ("mu", "nu"):
            state.append((f"dense_opt.{mom}.{n}", tuple(p.shape),
                          torch.float32, dspecs[n]))
    for name in ("master", "shadow", "accum"):
        t = getattr(st.table, name)
        state.append((f"table.{name}", (V, d), t.dtype, sspecs["table"][name]))
    # the port's τ=1 carry holds only the unique pairs and starts empty (a
    # declared divergence): its worst case is the reference's presized
    # (n_pend,) buffers, sharded like the batch
    carry = [("pending_ids", (n_pend,), torch.int32,
              sspecs["pending_ids"]),
             ("pending_rows", (n_pend, d), torch.float32,
              sspecs["pending_rows"])]
    step = make_gr_step_fn(bundle, loss_kwargs=dict(
        neg_mode="segmented", neg_segment=plan.neg_segment,
        expansion=plan.neg_expansion, remat=plan.remat,
        attn_fn=make_attn_fn(max_row_len=cfg.max_seq_len)),
        semi_async=True)
    dense_bytes = sum(p.numel() * p.element_size()
                      for p in dense.parameters())

    def run():
        return step(st, pack)[1]["loss"]
    worst = ["attention at its capacity: every row full length (K1-fwd, "
             "K2's padded work list; SASRec's softmax over every slot)",
             "unique table-grad pairs u = n: every id distinct (K6)",
             "AdaGrad's landing over u = n rows",
             "HSP exchange ids and rows, every id distinct (counted from "
             "shapes: the port's HSP runs one gloo process a rank, which a "
             "one-process fake world cannot host)"]
    extra = {"pend_spec": tuple(pend_spec), "n_pend": n_pend,
             "pack": {k: list(v.shape) for k, v in pack.items()},
             "carry_bytes_per_device_worst": _sharded_bytes(carry, mesh),
             "attention": "the port's kernels (K1-fwd/K2, block 128); the "
                          "reference's dry-run uses its XLA attention "
                          f"(q_block {plan.q_block})"}
    return Cell(cfg, shape, plan, mesh, run, state, worst,
                _hsp_worst_case(cfg, plan, mesh, pack, dense_bytes), extra)


# --------------------------------------------------------------------------
# the streaming serving layout
# --------------------------------------------------------------------------

def build_serve_cell(arch: str, *, max_users: int = 63,
                     rows_per_tick: int = 8, append_window: int = 4,
                     mesh=None, multi_pod: bool = False,
                     reduce_arch: bool = True,
                     mesh_device: Any = None) -> Dict[str, Any]:
    """The continuous-batching engine's layout (``StreamingRecallEngine``)
    on ``mesh`` (default the production mesh): the slot buffers (tokens,
    timestamps, embeddings; the K/V caches layer-major, as the port keeps
    them) as DTensors on ``meta`` with ``partition.gr_serve_specs``' specs,
    then one device's part of each program run on ``meta`` through the
    port's functions and kernels: the cold encode (``gr_encode_slots``,
    K1-fwd), the warm append (``gr_append_slots``, K1-fwd's append
    launch) and the rank (``topk_from_slots``), over its local slot rows
    and its vocab shard of the scan table, the tick's rows and the dense
    model replicated. Nothing is allocated. Returns the specs, each
    program's per-device argument bytes and kernels' costs."""
    from repro_torch.models import gr as GRM
    from repro_torch.serving.retrieval import topk_from_slots
    cfg = get_arch(arch)
    if not cfg.gr:
        raise ValueError(f"{arch} is not a GR arch")
    if reduce_arch:
        cfg = reduced(cfg)
    if mesh is None:
        if not MS.dist.is_initialized():
            MS.init_fake_world(512 if multi_pod else 256)
        mesh = MS.make_production_mesh(multi_pod=multi_pod,
                                       device=mesh_device)
    bundle = get_bundle(cfg)
    dense = bundle.init_dense(device=META)
    S, d = cfg.max_seq_len, cfg.d_model
    cap = GRM.slot_capacity(S)
    dqk = cfg.qkv_dim or cfg.resolved_head_dim
    L, H = cfg.num_layers, cfg.num_heads
    V = cfg.vocab_size
    specs = PT.gr_serve_specs(mesh, max_users=max_users, max_seq_len=cap,
                              d_model=d, kv_shape=(L, H, dqk, dqk),
                              vocab=V)
    dt = GRM.torch_dtype(cfg.dtype)
    N1, R, Q = max_users + 1, rows_per_tick, append_window
    i32 = torch.int32
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype,  # noqa
                                             device=META)
    kv = (L, N1, cap, H, dqk)
    bufs = {"tokens": (empty((N1, cap), i32), specs["tokens"]),
            "timestamps": (empty((N1, cap), i32), specs["timestamps"]),
            "emb": (empty((N1, d), dt), specs["emb"]),
            "kv_k": (empty(kv, dt), PT.serve_cache_spec(specs["kv_k"])),
            "kv_v": (empty(kv, dt), PT.serve_cache_spec(specs["kv_v"])),
            "scan_table": (empty((V, d), torch.float16),
                           specs["scan_table"])}
    local = {k: _distribute(t, mesh, s).to_local()
             for k, (t, s) in bufs.items()}
    out: Dict[str, Any] = {
        "arch": arch, "mesh_shape": PT.mesh_shape(mesh),
        "specs": {k: str(v) for k, v in specs.items()}, "ok": True}
    n_local = local["tokens"].shape[0]
    rows = empty((R,), i32)
    dense_bytes = sum(p.numel() * p.element_size()
                      for p in dense.parameters())

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    programs = {
        "cold": (lambda: GRM.gr_encode_slots(
            dense, cfg, empty((R, S, d), dt), empty((R, S), i32),
            empty((R,), i32), local["kv_k"], local["kv_v"], rows),
            nbytes(local["kv_k"], local["kv_v"], local["tokens"],
                   local["timestamps"], local["emb"])
            + nbytes(empty((R, S, d), dt)) + dense_bytes),
        "warm": (lambda: GRM.gr_append_slots(
            dense, cfg, empty((R, Q, d), dt), empty((R, S), i32),
            local["kv_k"], local["kv_v"], rows, empty((R,), i32),
            empty((R,), i32)),
            nbytes(local["kv_k"], local["kv_v"], local["tokens"],
                   local["timestamps"], local["emb"])
            + nbytes(empty((R, Q, d), dt)) + dense_bytes),
        "rank": (lambda: topk_from_slots(
            local["emb"], rows, local["scan_table"], k=16,
            block_v=min(4096, local["scan_table"].shape[0])),
            nbytes(local["emb"], local["scan_table"], rows)),
    }
    for name, (fn, arg_bytes) in programs.items():
        with OA.OpAnalysis() as an:
            fn()
        t = an.totals
        out[name] = {"argument_bytes": int(arg_bytes), "flops": t.flops,
                     "bytes": t.bytes,
                     "kernels": sorted({k["kernel"] for k in an.kernels})}
    out["local_slot_rows"] = n_local
    return out


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
               mesh=None, cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None,
               mesh_device: Any = None) -> Cell:
    """One cell on ``meta``: the production mesh (or ``mesh``; a fake
    world is made for the production mesh if no process group exists),
    the plan, the state and inputs with their placements, and the step.
    ``cfg``/``shape`` override the registry's (tests cut them).
    ``mesh_device``: the mesh's device type (None: the card's)."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    if mesh is None:
        if not MS.dist.is_initialized():
            MS.init_fake_world(512 if multi_pod else 256)
        mesh = MS.make_production_mesh(multi_pod=multi_pod,
                                       device=mesh_device)
    plan = PT.make_plan(cfg, shape, mesh)
    make = _gr_cell if cfg.gr else _lm_cell
    return make(cfg, shape, mesh, plan, META)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             ops_dir: str = "", mesh=None, mesh_name: Optional[str] = None,
             cfg: Optional[ArchConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh_device: Any = None) -> Dict[str, Any]:
    """Build a cell, run its step once on ``meta`` under
    :class:`~repro_torch.launch.op_analysis.OpAnalysis`, and return its
    record; ``ops_dir``: save the per-op records there
    (``<tag>.ops.json.gz``, for ``reanalyze``)."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, multi_pod, mesh=mesh, cfg=cfg,
                      shape=shape, mesh_device=mesh_device)
    t_build = time.perf_counter() - t0
    cfg, shape, plan, mesh = cell.cfg, cell.shape, cell.plan, cell.mesh
    mesh_name = mesh_name or MS.production_mesh_name(multi_pod)
    t0 = time.perf_counter()
    with OA.OpAnalysis() as an:
        cell.step()
    t_step = time.perf_counter() - t0
    for name, kind, nbytes in cell.collectives:
        an.records.append([name, "collective", 0.0, int(nbytes), 0, kind])
    totals = an.totals
    rl = RL.analyze(cfg, shape, mesh_name, mesh.size(), totals,
                    notes=plan.notes)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": mesh.size(), "ok": True}
    if cfg.gr:
        pend = cell.extra["pend_spec"]
        # a replicated fallback is () or (None,): both must trip
        assert any(ax is not None for ax in pend), \
            "GR τ=1 pending buffers must be sharded over the data axes"
        rec["pend_spec"] = str(pend)
    kernels: Dict[str, Dict[str, Any]] = {}
    for k in an.kernels:
        e = kernels.setdefault(k["kernel"], {"calls": 0, "operations": 0,
                                             "bytes": 0,
                                             "worst_case": False})
        e["calls"] += 1
        e["operations"] += k["operations"]
        e["bytes"] += k["bytes"]
        e["worst_case"] |= k["worst_case"]
    rec |= {
        "t_build_s": round(t_build, 1), "t_step_s": round(t_step, 1),
        "plan": plan.notes, "num_microbatches": plan.num_microbatches,
        "state_bytes_per_device": _sharded_bytes(cell.state, mesh),
        "cost": {"flops": totals.flops, "bytes accessed": totals.bytes},
        "totals": totals.to_dict(),
        "kernels": kernels,
        "worst_case": cell.worst_case,
        "collectives_from_shapes": [list(c) for c in cell.collectives],
        "top_ops": an.by_op(),
        "roofline": rl.to_dict(),
        "n_op_records": len(an.records),
        **{k: v for k, v in cell.extra.items() if k != "pend_spec"},
    }
    if ops_dir:
        os.makedirs(ops_dir, exist_ok=True)
        tag = f"{arch}__{shape.name}__{mesh_name}"
        with gzip.open(os.path.join(ops_dir, tag + ".ops.json.gz"),
                       "wt") as f:
            json.dump(an.records, f, default=str)
    return rec


def runnable_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) cell ``cells_for`` marks runnable."""
    return [(name, s.name) for name, cfg in ARCHS.items()
            for s, ok, _ in cells_for(cfg) if ok]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the fake mesh's device type (default: the "
                         "card's, 'cuda'; 'cpu' needs no card)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--stack-at", type=float, default=0.0,
                    help="print every thread's stack at this time (seconds "
                         "since the epoch): a sweep's timeout leaves it in "
                         "the cell's log")
    args = ap.parse_args(argv)
    if args.stack_at > 0:
        import faulthandler
        faulthandler.dump_traceback_later(max(0.5, args.stack_at
                                              - time.time()))

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = runnable_cells() if args.all else [(args.arch, args.shape)]
    if any(mp for mp in meshes):
        MS.init_fake_world(512)
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = MS.production_mesh_name(mp)
            tag = f"{arch}__{shape}__{mesh_name}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (exists)")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mp,
                               ops_dir=os.path.join(args.out, "ops"),
                               mesh_device=args.device)
                print(f"  ok: build {rec['t_build_s']}s, step "
                      f"{rec['t_step_s']}s, flops "
                      f"{rec['cost']['flops']:.3e}, state "
                      f"{rec['state_bytes_per_device'] / 1e9:.2f} GB, "
                      f"dominant {rec['roofline']['dominant']}",
                      flush=True)
            except Exception as e:                  # noqa: BLE001 — record
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "ok": False, "error": str(e)[:2000],
                       "traceback": traceback.format_exc()[-4000:]}
                print(f"  FAIL: {str(e)[:200]}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)


if __name__ == "__main__":
    main()
