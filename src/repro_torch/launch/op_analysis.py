"""Per-device operation, byte and collective counts of a step (the port's
counterpart of ``repro.launch.hlo_analysis``).

The reference parses the partitioned HLO of a compiled step. Nothing in
the port emits HLO, so the parser is not ported: :class:`OpAnalysis` is a
``TorchDispatchMode`` that watches one step run eagerly and totals, for
**one device**:

  * FLOPs — ``torch.utils.flop_counter``'s formulas over the ops this
    device runs, plus the costs the port's kernels record
    (``kernels/cost.py``: their own counts; on ``meta`` at the shape's
    worst case);
  * bytes — each op's tensor inputs read and its outputs written once
    (no fusion: an upper bound of the HBM traffic); views, aliases and
    allocations count zero; a gather (``index``, ``embedding``,
    ``index_select``, ``gather``) counts the rows it gathers and its
    indices, not the whole table, and a scatter the rows it writes (the
    reference's ``_has_sparse_access``);
  * collective bytes by kind — the operand bytes of every
    ``_c10d_functional`` collective the DTensor redistributions run (the
    reference's ``collective_bytes``), not counted as memory bytes.

Per device: over DTensors the mode declines the DTensor-level op (whose
shapes are global) and counts the local ops the DTensor dispatch runs on
this rank's shards, and the collectives it starts; the ops DTensor runs to
propagate shardings (on fake tensors) are not counted. Replicated compute
counts in full, as every device runs it. The port's loops run eagerly, so
no trip count is needed: each iteration's ops are seen.

The per-op records (:attr:`OpAnalysis.records`) are kept, so that
``launch/reanalyze.py`` can re-derive the totals and the roofline without
rebuilding a cell.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import cost as KC

#: The reference's collective kinds (HLO op names), by ``_c10d_functional``
#: op.
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")

#: Ops that read some rows of a large first operand by index: counted by
#: the rows they gather (their output) and their indices.
GATHER_OPS = {"index.Tensor", "embedding.default", "index_select.default",
              "gather.default"}
#: Ops that write some rows of their first operand by index: counted by
#: the rows written (read, modified, written) and their indices.
SCATTER_OPS = {"index_put.default", "index_put_.default",
               "_index_put_impl_.default", "index_add.default",
               "index_add_.default", "scatter_add.default",
               "scatter_add_.default", "scatter.src", "scatter_.src",
               "scatter.value", "scatter_.value", "index_copy_.default",
               "index_copy.default"}
#: Allocations and metadata: no traffic.
FREE_OPS = {"empty.memory_format", "empty_strided.default",
            "empty_like.default", "new_empty.default",
            "new_empty_strided.default", "lift_fresh.default",
            "_local_scalar_dense.default", "wait_tensor.default",
            "_wrap_tensor_autograd.default", "set_.source_Storage",
            "set_.source_Storage_storage_offset", "resize_.default"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


@dataclass
class Totals:
    """One device's totals: FLOPs, HBM bytes, collective operand bytes by
    kind, and the kernels' part of the FLOPs and bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in KINDS})
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": dict(self.coll_bytes),
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes}


def classify(name: str) -> str:
    """An op's byte rule: "free", "view", "gather", "scatter",
    "collective" or "compute"."""
    base = name.split(".", 1)[1] if name.startswith("_c10d_functional.") \
        else None
    if base is not None:
        return ("free" if base.split(".")[0] not in COLLECTIVE_KINDS
                else "collective")
    if name in FREE_OPS:
        return "free"
    if name in GATHER_OPS:
        return "gather"
    if name in SCATTER_OPS:
        return "scatter"
    return "compute"


def record_bytes(rec: List[Any]) -> float:
    """HBM bytes of one op record under the byte rules (see the module
    docstring)."""
    name, cls, flops, in_b, out_b, extra = rec
    if cls in ("free", "view", "collective"):
        return 0.0
    if cls == "gather":            # the gathered rows, read and written,
        return 2 * out_b + extra   # and the indices
    if cls == "scatter":           # the rows written (read and written),
        return 2 * extra[0] + extra[1]   # the values and indices read
    if cls == "kernel":
        return float(out_b)
    return float(in_b + out_b)


def totals_of(records: List[List[Any]]) -> Totals:
    """Re-derive :class:`Totals` from saved per-op records."""
    t = Totals()
    for rec in records:
        name, cls, flops, in_b, out_b, extra = rec
        b = record_bytes(rec)
        t.flops += flops
        t.bytes += b
        if cls == "collective":
            t.coll_bytes[extra] = t.coll_bytes.get(extra, 0.0) + in_b
        if cls == "kernel":
            t.kernel_flops += flops
            t.kernel_bytes += b
    return t


class OpAnalysis(TorchDispatchMode):
    """Count one device's work while the block runs (see the module
    docstring). ``records`` holds one ``[op, class, flops, input bytes,
    output bytes, extra]`` list per op (``extra``: a gather's index bytes,
    a scatter's (rows written, values and index bytes), a collective's
    kind), and one ``[kernel, "kernel", ops, 0, bytes, info]`` per kernel
    cost recorded (``kernels/cost.py``); :attr:`totals` sums them."""

    def __init__(self):
        super().__init__()
        self.records: List[List[Any]] = []
        self.kernels: List[Dict[str, Any]] = []
        self._collect = None

    # -- kernels -----------------------------------------------------------
    def _kernel(self, kernel: str, cost: KC.Cost, *, worst_case: bool,
                peak_dtype: Optional[str] = None, **info) -> None:
        rec = {"kernel": kernel, "operations": int(cost.operations),
               "bytes": int(cost.bytes), "special": int(cost.special),
               "worst_case": bool(worst_case), "peak_dtype": peak_dtype,
               **info}
        self.kernels.append(rec)
        self.records.append([kernel, "kernel", float(cost.operations), 0,
                             int(cost.bytes), rec])

    def __enter__(self):
        self._collect = KC.collecting(self._kernel)
        self._collect.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._collect.__exit__(*exc)
            self._collect = None

    # -- ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count the local ops instead
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        ins = _tensors((args, kwargs))
        if any(isinstance(x, FakeTensor) for x in ins):
            return out                     # DTensor's shape propagation
        self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out) -> None:
        name = str(func)
        if name.startswith("aten."):
            name = name[len("aten."):]
        cls = classify(name)
        outs = _tensors(out)
        if cls == "compute" and func.is_view:
            cls = "view"
        flops = 0.0
        from torch.utils.flop_counter import flop_registry
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            fa, fk = args, kwargs
            if func._overloadname == "dtype":
                # bmm/mm(..., out_dtype): the formulas take the operands
                fa = args[:2]
                fk = {k: v for k, v in kwargs.items() if k != "out_dtype"}
            flops = float(f(*fa, **fk, out_val=out))
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        extra: Any = 0
        if cls == "gather":
            extra = sum(_nbytes(t) for t in ins[1:])
        elif cls == "scatter":
            # the values (the last tensor operand) name the rows written
            extra = (_nbytes(ins[-1]), sum(_nbytes(t) for t in ins[1:]))
        elif cls == "collective":
            base = name.split(".", 2)[1]
            extra = COLLECTIVE_KINDS[base]
            in_b = _nbytes(ins[0]) if ins else 0
        self.records.append([name, cls, flops, in_b, out_b, extra])

    @property
    def totals(self) -> Totals:
        return totals_of(self.records)

    def by_op(self, top: int = 12) -> List[Dict[str, Any]]:
        """The ops (and kernels) with the most FLOPs or bytes, summed by
        name."""
        agg: Dict[str, Dict[str, float]] = {}
        for rec in self.records:
            a = agg.setdefault(rec[0], {"count": 0, "flops": 0.0,
                                        "bytes": 0.0})
            a["count"] += 1
            a["flops"] += rec[2]
            a["bytes"] += record_bytes(rec)
        rows = [{"op": k, **v} for k, v in agg.items()]
        rows.sort(key=lambda r: (r["flops"], r["bytes"]), reverse=True)
        return rows[:top]

