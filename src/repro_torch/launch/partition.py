"""Per-(arch × shape × mesh) parallelism plan (the port of
``repro.launch.partition``).

Maps every tensor of the system onto a ``DeviceMesh`` (or an
:class:`AbstractMesh`: axis sizes and names, no devices) with the
reference's rules and values:

  * dense backbone — TP over ``model`` (Megatron column/row pairs, the
    expert dim for MoE, the SSM inner dim), FSDP over ``data``, DP over
    ``pod`` × ``data``;
  * activations — batch over the DP axes, Megatron-SP (sequence over
    ``model``) between blocks for train and prefill, the KV cache's
    sequence over ``data`` for the batch-1 long-context decode cells;
  * GR (the paper) — the dense backbone replicated (≤ 0.2 B), the jagged
    batch over every axis, the embedding table's rows over ``model`` (HSP)
    or over every axis (global);
  * microbatching — ``num_microbatches`` so that one microbatch holds
    dp_size · samples_per_shard samples; bf16 grad accumulation and
    optimizer moments only where the reference's HBM budget asked for them
    (jamba-398B).

A spec here is a tuple of mesh axes per tensor dim (None, an axis name or
a tuple of them), what the reference's ``PartitionSpec`` holds; the
divisibility guard replicates a dim its axes do not divide
(``core.sharding.guard``). :func:`to_placements` turns a spec into DTensor
placements (the reference's ``to_named``), and :func:`shard_model` turns a
model's parameters into DTensors.

The port's LM keeps one ``LMLayer`` per layer where the reference stacks
each period slot's leaves over the periods: :func:`lm_param_specs` maps
each parameter to its reference leaf by name (``convert._lm_key``), applies
the leaf's rule to the stacked shape and drops the stacked axis (the rules
never shard it).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.sharding import axes_size, guard, placements_of

Axes = Any
Spec = Tuple[Axes, ...]

#: The environment variable whose JSON object patches every plan (the
#: reference's ``REPRO_PLAN_OVERRIDES``, under the port's name).
OVERRIDES_ENV = "REPRO_TORCH_PLAN_OVERRIDES"


@dataclass(frozen=True)
class Plan:
    arch: str
    shape: str
    rules: Dict[str, Axes]              # activation logical axes
    dp_axes: Tuple[str, ...]
    fsdp_axes: Optional[Tuple[str, ...]]
    num_microbatches: int
    accum_dtype: str
    opt_dtype: str
    q_block: int
    remat: bool
    hsp: bool = True                    # GR: hierarchical (vs global) table
    gr_layout: str = "pack"             # pack (one jagged buffer/device) |
                                        # rows (row-major padded)
    grad_wire_dtype: str = "float32"    # sparse-exchange wire dtype
    neg_expansion: int = 1              # §4.3.3 logit sharing factor
    neg_segment: int = 128              # §4.3.1 segment size
    gr_score_dtype: str = "float32"     # the reference's XLA-path scores
    attn_tp: bool = True                # False: context-parallel attention
    notes: str = ""


def _apply_overrides(plan: Plan) -> Plan:
    """``REPRO_TORCH_PLAN_OVERRIDES='{"num_microbatches": 4, ...}'`` patches
    every plan's fields of those names."""
    raw = os.environ.get(OVERRIDES_ENV)
    if not raw:
        return plan
    kw = json.loads(raw)
    return dataclasses.replace(
        plan, **{k: v for k, v in kw.items() if hasattr(plan, k)},
        notes=plan.notes + f" | overrides={kw}")


class AbstractMesh(NamedTuple):
    """A mesh's axis sizes and names and no devices (the reference's
    ``jax.sharding.AbstractMesh``): plans and specs need nothing else, so
    they can be made without a process group."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size, in the mesh's order (the reference's
    ``mesh.shape``)."""
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.shape)}


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def make_plan(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Plan:
    dp = _dp_axes(mesh)
    dp_size = axes_size(mesh, dp)
    big = cfg.d_model * cfg.num_layers >= 8192 * 64      # jamba-class
    opt_dtype = "bfloat16" if big else "float32"
    accum_dtype = "bfloat16" if big else "float32"

    if cfg.gr:
        all_axes = mesh_axes(mesh)
        rules = {"batch": all_axes, "tp": None, "act_sp": None,
                 "vocab": "model"}
        return _apply_overrides(Plan(
            cfg.name, shape.name, rules, dp_axes=all_axes,
            fsdp_axes=None, num_microbatches=1,
            accum_dtype="float32", opt_dtype="float32",
            q_block=512, remat=True, hsp=True,
            notes="GR: dense replicated, table HSP over model axis"))

    model_size = axes_size(mesh, "model")
    if shape.kind == "train":
        if cfg.d_model >= 8192:
            per_shard = 1
        elif cfg.d_model >= 4096:
            per_shard = 2
        else:
            per_shard = 4
        mb_samples = dp_size * per_shard
        num_mb = max(1, shape.global_batch // mb_samples)
        while shape.global_batch % num_mb or \
                (shape.global_batch // num_mb) % dp_size:
            num_mb -= 1
        rules = {"batch": dp if len(dp) > 1 else dp[0],
                 "act_sp": "model", "tp": "model", "vocab": "model"}
        attn_tp = cfg.num_heads == 0 or cfg.num_heads % model_size == 0
        return _apply_overrides(Plan(
            cfg.name, shape.name, rules, dp_axes=dp,
            fsdp_axes=("data",), num_microbatches=num_mb,
            accum_dtype=accum_dtype, opt_dtype=opt_dtype,
            q_block=min(1024, shape.seq_len), remat=True, attn_tp=attn_tp,
            notes=f"TP16 + SP + FSDP(data) + DP, {num_mb} microbatches"
                  + ("" if attn_tp else " + CP attention")))

    if shape.kind == "prefill":
        rules = {"batch": dp if len(dp) > 1 else dp[0],
                 "act_sp": "model", "tp": "model", "vocab": "model"}
        return _apply_overrides(Plan(
            cfg.name, shape.name, rules, dp_axes=dp,
            fsdp_axes=("data",), num_microbatches=1,
            accum_dtype=accum_dtype, opt_dtype=opt_dtype,
            q_block=1024, remat=False,
            notes="prefill: TP + SP, batch over DP"))

    # decode
    if shape.global_batch >= dp_size:
        batch_ax: Axes = dp if len(dp) > 1 else dp[0]
        cache_seq_ax: Axes = None
    else:
        batch_ax = None                      # B=1 long-context
        cache_seq_ax = dp if len(dp) > 1 else dp[0]
    rules = {"batch": batch_ax, "act_sp": None, "tp": "model",
             "vocab": "model", "cache_seq": cache_seq_ax}
    return _apply_overrides(Plan(
        cfg.name, shape.name, rules, dp_axes=dp,
        fsdp_axes=None, num_microbatches=1,
        accum_dtype=accum_dtype, opt_dtype=opt_dtype,
        q_block=1, remat=False,
        notes=("decode: batch over DP" if batch_ax else
               "long-context decode: KV-cache sequence over data")))


# --------------------------------------------------------------------------
# spec construction helpers
# --------------------------------------------------------------------------

def _guard(mesh, shape: Sequence[int], dims) -> Spec:
    """Drop any axis that does not divide its dim."""
    return guard(mesh, tuple(shape), tuple(dims))


def _replicated(nd: int) -> Spec:
    return (None,) * nd


def _leaf_dims_lm(name: str, nd: int, plan: Plan) -> Spec:
    """The reference's partition rule of an LM leaf by its name and rank
    (the rank of the reference's stacked leaf), before the guard."""
    fsdp = plan.fsdp_axes[0] if plan.fsdp_axes else None
    tp = "model"
    if nd == 4 and name in ("w_in", "w_gate", "w_out"):
        # MoE expert tensors (Np, E, din, dout): FSDP on the hidden dim
        if name == "w_out":
            return (None, tp, fsdp, None)
        return (None, tp, None, fsdp)
    if name == "embed":
        return (tp, fsdp)
    if name == "lm_head":
        return (fsdp, tp)
    if name in ("wq", "wk", "wv"):
        return (None, fsdp, tp if plan.attn_tp else None)
    if name == "wo":
        return (None, tp if plan.attn_tp else None, fsdp)
    if name in ("w_in", "w_gate", "in_z", "in_x", "in_bc", "in_dt",
                "shared_w_in", "shared_w_gate"):
        return (None, fsdp, tp)                # (Np, d, out): column-parallel
    if name in ("w_out", "out_proj", "shared_w_out"):
        return (None, tp, fsdp)                # (Np, in, d): row-parallel
    if name == "router":
        return (None, None, None)
    return _replicated(nd)                     # norms, biases, scalars


def lm_leaf_spec(param_name: str, shape: Sequence[int], num_periods: int,
                 period: int, mesh, plan: Plan) -> Tuple[Spec, Spec]:
    """(the spec of ``param_name``'s reference leaf, with its stacked
    period axis when it has one; the port parameter's spec, that axis
    dropped)."""
    from repro_torch.convert import _lm_key
    path, per = _lm_key(param_name, period)
    stacked = per is not None
    ref_shape = ((num_periods,) if stacked else ()) + tuple(shape)
    ref = _guard(mesh, ref_shape,
                 _leaf_dims_lm(str(path[-1]), len(ref_shape), plan))
    if stacked:
        assert ref[0] is None, f"{param_name}: the stacked axis is sharded"
    return ref, ref[1:] if stacked else ref


def lm_param_specs(model, mesh, plan: Plan) -> Dict[str, Spec]:
    """Parameter name → spec for an ``LM`` (or its parameters on ``meta``):
    each parameter gets its reference leaf's rule, the stacked period axis
    dropped."""
    from repro_torch.models.transformer import period_len
    cfg = model.cfg
    p = period_len(cfg)
    return {n: lm_leaf_spec(n, t.shape, cfg.num_layers // p, p, mesh,
                            plan)[1]
            for n, t in model.named_parameters()}


def gr_param_specs(model, mesh, plan: Plan) -> Dict[str, Spec]:
    """GR dense backbone ≤ 0.2 B → replicated (the paper's layout)."""
    return {n: _replicated(t.dim()) for n, t in model.named_parameters()}


def gr_table_spec(mesh, plan: Plan) -> Spec:
    if plan.hsp:
        return ("model", None)
    return (mesh_axes(mesh), None)


def gr_pend_spec(mesh, n_pend: int) -> Spec:
    """The τ=1 pending (id, row) pairs: batch-derived, so their pair dim
    shards over the data axes like the batch (replicated when ``n_pend``
    does not divide their size)."""
    dp = _dp_axes(mesh)
    if not dp:
        return ()
    return _guard(mesh, (n_pend,), (dp,))


def gr_serve_specs(mesh, *, max_users: int, max_seq_len: int, d_model: int,
                   kv_shape: Optional[Tuple[int, int, int, int]] = None,
                   vocab: int = 0) -> Dict[str, Spec]:
    """The streaming engine's layout over a serving mesh: the slot rows
    (leading dim ``max_users + 1``, the scratch lane included) over the
    data axes; the K/V caches also their heads over ``model``; the
    retrieval scan table's vocab over ``model``; the tick's ``rows`` and
    the dense backbone replicated. The specs are the reference's, in its
    slot-major layout: the K/V caches ``(N+1, L, S, H, d)``. The port's
    caches are layer-major, ``(L, N+1, S, H, d)``
    (:func:`serve_cache_spec` moves the spec)."""
    dp = _dp_axes(mesh) or None
    model = "model" if "model" in mesh_axes(mesh) else None
    rows = max_users + 1
    out: Dict[str, Spec] = {
        "tokens": _guard(mesh, (rows, max_seq_len), (dp, None)),
        "timestamps": _guard(mesh, (rows, max_seq_len), (dp, None)),
        "emb": _guard(mesh, (rows, d_model), (dp, None)),
        "rows": (),
        "scan_table": _guard(mesh, (vocab, d_model), (model, None)),
    }
    if kv_shape is not None:
        L, H, dqk, dv = kv_shape
        out["kv_k"] = _guard(mesh, (rows, L, max_seq_len, H, dqk),
                             (dp, None, None, model, None))
        out["kv_v"] = _guard(mesh, (rows, L, max_seq_len, H, dv),
                             (dp, None, None, model, None))
    return out


def serve_cache_spec(spec: Spec) -> Spec:
    """A slot-major K/V spec ``(N+1, L, ...)`` of :func:`gr_serve_specs` for
    the port's layer-major caches ``(L, N+1, ...)``."""
    return (spec[1], spec[0], *spec[2:])


# --------------------------------------------------------------------------
# batch / cache / state specs
# --------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, plan: Plan,
                inputs: Dict[str, Any]) -> Dict[str, Any]:
    """The spec of every input of ``bundle.input_specs`` (its leaves:
    tensors on ``meta``; the decode cache a ``DecodeCache``)."""
    b = plan.rules.get("batch")

    def bspec(x):
        return _guard(mesh, x.shape, (b,) + (None,) * (x.dim() - 1))

    out: Dict[str, Any] = {}
    if "batch" in inputs:
        out["batch"] = {k: bspec(v) for k, v in inputs["batch"].items()}
        if cfg.gr:
            out["batch"]["rng"] = (None,)
        return out
    for k, v in inputs.items():
        if k == "cache_index":
            out[k] = ()
        elif k == "cache":
            out[k] = cache_specs(cfg, v, mesh, plan)
        else:
            out[k] = bspec(v)
    return out


def cache_specs(cfg: ArchConfig, cache, mesh, plan: Plan) -> Dict[str, Any]:
    """Specs of a ``DecodeCache``, per layer, with the reference's rules
    applied to its stacked leaves (``(Np, B, S, Hkv, hd)`` K/V,
    ``(Np, B, K-1, C)`` conv, ``(Np, B, H, P, N)`` SSM state) and the
    stacked axis dropped: ``{"kv": {layer: (k, v)}, "ssm": {layer:
    {"ssm": ..., "conv": ...}}}``."""
    b = plan.rules.get("batch")
    seq_ax = plan.rules.get("cache_seq")

    def route(shp):
        shp = (1,) + tuple(shp)                 # the stacked period axis
        if len(shp) == 5:
            if shp[2] >= 1024:                  # kv (Np, B, S, Hkv, hd)
                return _guard(mesh, shp, (None, b, seq_ax, "model",
                                          None))[1:]
            return _guard(mesh, shp, (None, b, "model", None, None))[1:]
        if len(shp) == 4:                       # conv (Np, B, K-1, C)
            return _guard(mesh, shp, (None, b, None, "model"))[1:]
        return _replicated(len(shp) - 1)

    return {"kv": {i: tuple(route(t.shape) for t in kv)
                   for i, kv in cache.kv.items()},
            "ssm": {i: {k: route(t.shape) for k, t in st.items()}
                    for i, st in cache.ssm.items()}}


def state_specs(param_specs: Dict[str, Spec], mesh) -> Dict[str, Any]:
    """AdamW / LMTrainState specs mirroring the params (count and step
    replicated)."""
    return {"params": dict(param_specs),
            "opt": {"mu": dict(param_specs), "nu": dict(param_specs),
                    "count": ()},
            "step": ()}


def gr_state_specs(dense_specs: Dict[str, Spec], table_spec: Spec,
                   pend_spec: Optional[Spec] = None,
                   with_shadow: bool = True) -> Dict[str, Any]:
    """master, shadow and accumulator share the table's spec; the τ=1
    pending pairs shard their leading dim as ``pend_spec`` says (default
    replicated). ``with_shadow=False`` for a state built without a
    shadow."""
    pend = pend_spec if pend_spec is not None else ()
    pend_rows = tuple(pend) + (None,) if pend_spec is not None else ()
    table = {"master": table_spec, "accum": table_spec}
    if with_shadow:
        table["shadow"] = table_spec
    return {"dense": dict(dense_specs),
            "dense_opt": {"mu": dict(dense_specs), "nu": dict(dense_specs),
                          "count": ()},
            "table": table, "pending_ids": pend, "pending_rows": pend_rows,
            "step": ()}


# --------------------------------------------------------------------------
# placements
# --------------------------------------------------------------------------

def to_placements(mesh, spec: Spec) -> list:
    """A spec's DTensor placements on ``mesh`` (the reference's
    ``to_named``): each mesh axis shards the dim it is mapped to, the
    others replicate."""
    return placements_of(mesh, tuple(spec))


def spec_bytes(shape: Sequence[int], dtype: torch.dtype, spec: Spec,
               mesh) -> int:
    """Bytes of one device's shard of a ``shape`` tensor under ``spec``
    (the dims divide: the guard saw to it)."""
    n = 1
    for size in shape:
        n *= int(size)
    denom = 1
    for ax in spec:
        denom *= axes_size(mesh, ax)
    return n * torch.empty((), dtype=dtype).element_size() // max(denom, 1)


def shard_model(model: torch.nn.Module, mesh, plan: Plan,
                specs: Optional[Dict[str, Spec]] = None) -> torch.nn.Module:
    """The model's parameters as DTensors on ``mesh``, in place: an ``LM``
    by :func:`lm_param_specs`, a GR dense model replicated
    (:func:`gr_param_specs`), or by ``specs`` when given. Each parameter
    is ``distribute_tensor``'d from its full value (every rank holds the
    full value first; on ``meta`` nothing is allocated). Returns
    ``model``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.core.sharding import register_dtensor_rules
    register_dtensor_rules()
    if specs is None:
        gr = getattr(getattr(model, "cfg", None), "gr", False)
        specs = (gr_param_specs if gr else lm_param_specs)(model, mesh,
                                                           plan)
    for name, prm in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = distribute_tensor(prm.detach(), mesh,
                              to_placements(mesh, specs[name]))
        setattr(mod, leaf, torch.nn.Parameter(d, requires_grad=
                                              prm.requires_grad))
    return model
