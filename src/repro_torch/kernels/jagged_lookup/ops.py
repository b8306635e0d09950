"""The jagged embedding lookup: the row gather, and the sorted run-sum
deduplication of sparse (id, row) pairs and the scatters built on it (the
port of ``repro.kernels.jagged_lookup.ops``).

:func:`jagged_lookup` is the differentiable packed-index gather (§4.1.2):
forward K7 (``csrc/gather.cu``, the clip, the mask of ids < 0 and the cast
fused into the gather), backward :func:`scatter_add_rows`;
:func:`multi_table_lookup` runs it once over the tables stacked
table-major.

:func:`unique_pairs` sorts the pairs by id (the table-major regrouping) and
reduces each run of equal ids with K6 (``csrc/runsum.cu``) for CUDA tensors
or its plain version (``ref.run_totals_plain``) for CPU tensors: the
unique (id, grad-row) pairs the sparse optimizer consumes. On ``meta``
tensors (the dry-run) the run-sums give their outputs at the worst case,
every id distinct (u = n), and record their kernels' costs
(``kernels/cost.py``) there; neither the kernel nor the plain version
runs.
:func:`weighted_run_totals` (K5, ``csrc/wscatter.cu``) does the same for
rows given in factored form, ``w · o[src] · scale``, generating each row
inside the kernel so the rows are never built in device memory; ready rows
can join the same sorted stream. :func:`dedup_rows` lays K6's totals out
as the reference does (at each run's last slot), and
:func:`scatter_add_rows` and :func:`scatter_add_weighted_rows` build dense
(V, D) arrays from them: test-size oracles, never on the port's training
path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as KC
from repro_torch.kernels.jagged_lookup import ref as R

#: Launches of each kernel in this module, counted where the wrapper
#: launches it and nowhere else.
KERNEL_LAUNCHES: Dict[str, int] = {"runsum": 0, "wscatter": 0, "gather": 0}

#: Sort key of dropped (negative) ids: they sort last, in one run.
DROP_KEY = 2 ** 30

_CTAS_PER_SM = 8
_RUNSUM_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
_WSCATTER_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_void_p])
_O_CODE = {torch.float32: 0, torch.bfloat16: 1}
_G_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_GATHER_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def _lib(name: str):
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = {"runsum": _RUNSUM_ARGTYPES,
                       "wscatter": _WSCATTER_ARGTYPES}[name]
        fn.restype = ctypes.c_int
    return lib


def _require(cond: bool, msg: str, kernel: str = "runsum") -> None:
    if not cond:
        raise ValueError(f"{kernel} kernel: {msg}")


def run_starts(sids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run pointers of a sorted id list, on its device without a host
    sync: (starts (n+1,) int32 — starts[r] the first slot of run r, n from
    the run count on —, num_runs (1,) int32)."""
    n = sids.numel()
    is_start = torch.ones(n, dtype=torch.bool, device=sids.device)
    is_start[1:] = sids[1:] != sids[:-1]
    run = torch.cumsum(is_start.to(torch.int32), 0) - 1
    starts = torch.full((n + 1,), n, dtype=torch.int32, device=sids.device)
    slot = torch.where(is_start, run, n).long()
    starts.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                          device=sids.device))
    starts[n] = n           # non-start slots all wrote to slot n
    return starts, (run[-1:] + 1).to(torch.int32)


def _launch_runsum(rows: torch.Tensor, order: torch.Tensor,
                   sids: torch.Tensor, starts: torch.Tensor,
                   num_runs: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    dev = rows.device
    _require(dev.type == "cuda", f"tensors on {dev}, not on the card")
    _require(rows.dtype == torch.float32 and rows.dim() == 2,
             f"rows {rows.dtype} {tuple(rows.shape)}; takes (n, D) float32")
    n, D = rows.shape
    _require(D % 4 == 0, f"row width {D} is not a multiple of 4")
    _require(order.dtype == torch.int64 and sids.dtype == torch.int32
             and order.shape == (n,) and sids.shape == (n,)
             and order.device == dev and sids.device == dev,
             "order (n,) int64 and sorted ids (n,) int32 on the rows' device")
    _require(rows.is_contiguous() and rows.data_ptr() % 16 == 0
             and out.is_contiguous() and out.data_ptr() % 16 == 0,
             "rows and out must be contiguous and 16-byte aligned")
    ctas = _ctas(dev, n)
    lib = _lib("runsum")
    with torch.cuda.device(dev):
        rc = lib.runsum(rows.data_ptr(), order.contiguous().data_ptr(),
                        sids.contiguous().data_ptr(), starts.data_ptr(),
                        num_runs.data_ptr(), out.data_ptr(), n, D, DROP_KEY,
                        ctas,
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"runsum launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["runsum"] += 1
    return out


def _ctas(dev: torch.device, n: int) -> int:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(n, sms * _CTAS_PER_SM))


def _launch_wscatter(o: torch.Tensor, w: torch.Tensor, extra: torch.Tensor,
                     order: torch.Tensor, sids: torch.Tensor,
                     starts: torch.Tensor, num_runs: torch.Tensor,
                     out: torch.Tensor, *, scale: float) -> torch.Tensor:
    dev = o.device
    req = lambda c, m: _require(c, m, "wscatter")         # noqa: E731
    req(dev.type == "cuda", f"tensors on {dev}, not on the card")
    req(o.dtype in _O_CODE and o.dim() == 2,
        f"o {o.dtype} {tuple(o.shape)}; takes (T, D) float32 or bfloat16")
    D = o.shape[1]
    n = sids.numel()
    n_neg = n - extra.shape[0]
    R = w.shape[1]
    req(D % 4 == 0, f"row width {D} is not a multiple of 4")
    req(w.dtype == torch.float32 and w.dim() == 2 and w.is_contiguous()
        and 0 <= n_neg <= w.numel() and -(-n_neg // R) <= o.shape[0],
        f"w {w.dtype} {tuple(w.shape)} for {n_neg} negative slots of "
        f"{o.shape[0]} rows; takes contiguous (T, R) float32")
    req(extra.dtype == torch.float32 and extra.dim() == 2
        and extra.shape[1] == D, f"extra rows {extra.dtype} "
        f"{tuple(extra.shape)}; takes (n_extra, {D}) float32")
    req(order.dtype == torch.int64 and sids.dtype == torch.int32
        and order.shape == (n,) and order.is_contiguous()
        and sids.is_contiguous()
        and all(t.device == dev for t in (w, extra, order, sids, out)),
        "order (n,) int64 and sorted ids (n,) int32 on o's device")
    req(o.is_contiguous() and o.data_ptr() % 16 == 0
        and extra.is_contiguous() and extra.data_ptr() % 16 == 0
        and out.is_contiguous() and out.data_ptr() % 16 == 0,
        "o, extra and out must be contiguous and 16-byte aligned")
    lib = _lib("wscatter")
    with torch.cuda.device(dev):
        rc = lib.wscatter(o.data_ptr(), w.data_ptr(), extra.data_ptr(),
                          order.data_ptr(), sids.data_ptr(),
                          starts.data_ptr(), num_runs.data_ptr(),
                          out.data_ptr(), n_neg, n, R, D, _O_CODE[o.dtype],
                          DROP_KEY, _ctas(dev, n), scale,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wscatter launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["wscatter"] += 1
    return out


def _device_check(rows: torch.Tensor) -> bool:
    """True: launch the kernel; False: the plain version (CPU tensors)."""
    if rows.device.type not in ("cuda", "cpu"):
        raise ValueError(f"jagged_lookup: unsupported device {rows.device}")
    return rows.device.type == "cuda"


def _record_runs(kernel: str, n: int, n_runs: int, D: int, *,
                 worst_case: bool, T: int = 0, n_neg: int = 0,
                 o_itemsize: int = 2) -> None:
    """Hand a K5/K6 call's cost to the active analysis."""
    if KC.active():
        c = (KC.runsum_cost(n, n_runs, D) if kernel == "runsum" else
             KC.wscatter_cost(T, n_neg, n, n_runs, D,
                              o_itemsize=o_itemsize))
        KC.record(kernel, c, worst_case=worst_case, runs=n_runs, slots=n)


def _runs(sids: torch.Tensor):
    """(starts, num_runs, n_runs, n_kept, run ids): one host sync reads the
    run count and whether the last run is the dropped one, so outputs are
    allocated at their size. On ``meta`` (no data, no sync): the worst
    case, every slot its own run and none dropped."""
    if sids.device.type == "meta":
        n = sids.numel()
        return None, None, n, n, sids
    starts, num_runs = run_starts(sids)
    n_runs, dropped = torch.cat([num_runs, (sids[-1:] >= DROP_KEY).to(
        torch.int32)]).tolist()
    return (starts, num_runs, n_runs, n_runs - dropped,
            sids[starts[:n_runs].long()])


def run_totals(rows: torch.Tensor, order: torch.Tensor, sids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (ids (u,) int32 ascending, totals (u, D) fp32), one per run of
    ids ≥ 0 (the dropped run left out), the plain version for CPU
    tensors."""
    rows = rows.float().contiguous()
    if sids.numel() == 0:
        return sids, rows
    starts, num_runs, n_runs, u, ids = _runs(sids)
    if rows.device.type == "meta":
        _record_runs("runsum", sids.numel(), n_runs, rows.shape[1],
                     worst_case=True)
        return ids[:u], rows.new_empty((u, rows.shape[1]))
    if _device_check(rows):
        out = rows.new_empty((n_runs, rows.shape[1]))
        _launch_runsum(rows, order, sids, starts, num_runs, out)
        _record_runs("runsum", sids.numel(), n_runs, rows.shape[1],
                     worst_case=False)
    else:
        out = R.run_totals_plain(rows, order, sids, n_runs, DROP_KEY)
    return ids[:u], out[:u]


def weighted_run_totals(o: torch.Tensor, w: torch.Tensor,
                        extra: torch.Tensor, order: torch.Tensor,
                        sids: torch.Tensor, *, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: :func:`run_totals` over rows given in factored form.

    The n = ``sids.numel()`` slots are the n_neg = n − len(extra) negative
    slots, slot j the row ``w.flat[j] · (o[j // R] · scale)`` (w (T, R),
    t-major, o (T, D) fp32 or bf16), then the ready fp32 rows ``extra``;
    ``order``/``sids`` sort them (:func:`sort_pairs`). Returns (ids (u,)
    int32 ascending, totals (u, D) fp32), one per run of ids ≥ 0: the
    kernel for card tensors, the plain version for CPU tensors. Equal bit
    for bit to building the rows (``w[:, :, None] · (o.float() · scale)``)
    and :func:`run_totals` over them."""
    if sids.numel() == 0:
        return sids, extra.float()
    starts, num_runs, n_runs, u, ids = _runs(sids)
    rec = dict(T=o.shape[0], n_neg=sids.numel() - extra.shape[0],
               o_itemsize=o.element_size())
    if o.device.type == "meta":
        _record_runs("wscatter", sids.numel(), n_runs, o.shape[1],
                     worst_case=True, **rec)
        return ids[:u], extra.new_empty((u, o.shape[1]),
                                        dtype=torch.float32)
    if _device_check(o):
        out = extra.new_empty((n_runs, o.shape[1]), dtype=torch.float32)
        _launch_wscatter(o, w, extra, order, sids, starts, num_runs, out,
                         scale=scale)
        _record_runs("wscatter", sids.numel(), n_runs, o.shape[1],
                     worst_case=False, **rec)
    else:
        out = R.weighted_run_totals_plain(o, w, extra, order, sids, n_runs,
                                          DROP_KEY, scale)
    return ids[:u], out[:u]


def sort_pairs(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order int64, sorted keys int32) of ids, dropped (< 0) ids keyed
    DROP_KEY so they sort last; stable, like the reference's argsort."""
    skey = torch.where(ids >= 0, ids.to(torch.int32), DROP_KEY)
    order = torch.argsort(skey, stable=True)
    return order, skey[order]


def dedup_rows(grad_rows: torch.Tensor, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted run-sum deduplication of (id, row) pairs, in the reference's
    layout.

    Returns ``(uids, sums)`` of the input length in sorted order:
    ``uids[i]`` is the id at each run's last slot (−1 elsewhere and for
    dropped ids < 0) and ``sums[i]`` the run's total there (zero
    elsewhere). Consumers index only the ``uids >= 0`` slots. The totals
    are :func:`unique_pairs`' (K6), copied to the run ends: a test-size
    API, off the training path."""
    ids = ids.reshape(-1)
    if grad_rows.shape[0] != ids.shape[0]:
        raise ValueError(f"{grad_rows.shape[0]} rows for {ids.shape[0]} ids")
    order, sids = sort_pairs(ids)
    _, totals = run_totals(grad_rows, order, sids)
    is_end = torch.ones_like(sids, dtype=torch.bool)
    is_end[:-1] = sids[:-1] != sids[1:]
    is_end &= sids < DROP_KEY
    uids = torch.where(is_end, sids, -1)
    sums = grad_rows.new_zeros(grad_rows.shape, dtype=torch.float32)
    sums[is_end] = totals          # kept runs ascend, as their totals do
    return uids, sums


def unique_pairs(grad_rows: torch.Tensor, ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (u,) int32 ascending, rows (u, D) fp32): one pair per distinct
    id ≥ 0, its rows summed in sorted order by K6."""
    ids = ids.reshape(-1)
    if grad_rows.shape[0] != ids.shape[0]:
        raise ValueError(f"{grad_rows.shape[0]} rows for {ids.shape[0]} ids")
    order, sids = sort_pairs(ids)
    return run_totals(grad_rows, order, sids)


def scatter_add_rows(grad_rows: torch.Tensor, ids: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """Σ grad_rows per id → dense (vocab, D) fp32; ids outside [0, vocab)
    dropped. Builds the (V, D) array: a test-size oracle."""
    u, rows = unique_pairs(grad_rows, ids)
    keep = u < vocab
    out = torch.zeros((vocab, grad_rows.shape[1]), dtype=torch.float32,
                      device=grad_rows.device)
    out[u[keep].long()] = rows[keep]
    return out


SCATTER_IMPLS = ("fused", "two_pass")


def check_scatter_impl(impl: str) -> None:
    if impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown scatter impl {impl!r}; one of "
                         f"{SCATTER_IMPLS}")


def scatter_add_weighted_rows(weights: torch.Tensor, o: torch.Tensor,
                              ids: torch.Tensor, vocab: int, *,
                              scale: float = 1.0,
                              impl: str = "fused") -> torch.Tensor:
    """Σ over (t, r) of ``weights[t, r] · o[t] · scale`` per id → (V, D);
    ids outside [0, vocab) dropped.

    ``impl="fused"`` (the default, the reference's): the rows are generated
    inside the weighted run-sum scatter (K5, :func:`weighted_run_totals`)
    and never built. ``impl="two_pass"``, the oracle: build every row, then
    :func:`scatter_add_rows`. The two agree bit for bit."""
    check_scatter_impl(impl)
    T, R = weights.shape
    D = o.shape[1]
    ids = ids.reshape(-1)
    keyed = torch.where((ids >= 0) & (ids < vocab), ids, -1)
    if impl == "two_pass":
        # the rows w[t, r]·(o[t]·scale), t-major: the reference's op order
        rows = (weights.float()[:, :, None]
                * (o.float() * scale)[:, None, :]).reshape(T * R, D)
        return scatter_add_rows(rows, keyed, vocab)
    order, sids = sort_pairs(keyed)
    u, rows = weighted_run_totals(
        o.contiguous(), weights.float().contiguous(),
        torch.zeros((0, D), dtype=torch.float32, device=o.device), order,
        sids, scale=scale)
    out = torch.zeros((vocab, D), dtype=torch.float32, device=o.device)
    out[u.long()] = rows
    return out


# --------------------------------------------------------------------------
# K7: the jagged lookup's row gather
# --------------------------------------------------------------------------

def _gather_lib():
    lib = _build.load("gather")
    if lib.gather_rows.argtypes is None:
        lib.gather_rows.argtypes = _GATHER_ARGTYPES
        lib.gather_rows.restype = ctypes.c_int
    return lib


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """K7 for card tensors, its plain version for CPU tensors: ids (n,) →
    (n, D) ``dtype``, ``table[min(id, V − 1)]`` cast once, zeros for ids
    < 0 (no read)."""
    if not _device_check(table):
        return R.jagged_lookup_ref(table, ids, compute_dtype=dtype)
    req = lambda c, m: _require(c, m, "gather")           # noqa: E731
    V, D = table.shape
    req(table.dtype in _G_CODE and dtype in _G_CODE,
        f"table {table.dtype} to {dtype}; takes float32, bfloat16, float16")
    req(table.is_contiguous() and table.data_ptr() % 16 == 0
        and D % (16 // table.element_size()) == 0,
        f"table must be contiguous, 16-byte aligned, its rows ({D}) a whole "
        f"number of 16-byte vectors")
    req(ids.dim() == 1 and ids.device == table.device,
        "ids (n,) on the table's device")
    ids = ids.to(torch.int32).contiguous()
    out = torch.empty((ids.numel(), D), dtype=dtype, device=table.device)
    if ids.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        rc = _gather_lib().gather_rows(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(), V,
            D, _G_CODE[table.dtype], _G_CODE[dtype],
            torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["gather"] += 1
    return out


class _JaggedLookup(torch.autograd.Function):
    """Forward K7 (or its plain version); backward the dense scatter of the
    row grads (:func:`scatter_add_rows`, K6 on the card)."""

    @staticmethod
    def forward(ctx, table, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.table_dtype = table.shape[0], table.dtype
        return gather_rows(table, ids, dtype)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        grad = scatter_add_rows(g.float(), ids, ctx.vocab)
        return grad.to(ctx.table_dtype), None, None


def jagged_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable packed-index gather: ids (...) int → (..., D)
    ``compute_dtype`` (the reference takes flat (n,) ids only); ids < 0
    give zero rows and no gradient, ids ≥ V read row V − 1 (the reference
    clips them). The table's grad is dense (V, D): the lookup of test sizes
    and of callers that bind it as the model's ``lookup_fn`` (the train
    step takes its rows as leaves and never builds that grad)."""
    out = _JaggedLookup.apply(table, ids.reshape(-1), compute_dtype)
    return out.reshape(*ids.shape, table.shape[1])


def multi_table_lookup(tables: Sequence[torch.Tensor],
                       ids_per_table: Sequence[torch.Tensor], *,
                       compute_dtype=torch.bfloat16
                       ) -> Tuple[torch.Tensor, ...]:
    """Fused table-major lookup, one K7 launch over the stacked tables
    (Fig. 3's batch restructuring): all tables share D; each table's ids
    are shifted into the stacked row space (ids < 0 stay −1) and
    concatenated table-major. → one (n_i, D) block per table."""
    D = tables[0].shape[1]
    if any(t.shape[1] != D for t in tables):
        raise ValueError("multi_table_lookup: tables of different widths")
    offs = [0]
    for t in tables:
        offs.append(offs[-1] + t.shape[0])
    stacked = torch.cat(list(tables), dim=0)
    flat = torch.cat([torch.where(i.reshape(-1) >= 0, i.reshape(-1) + off, -1)
                      for i, off in zip(ids_per_table, offs[:-1])])
    out = jagged_lookup(stacked, flat, compute_dtype=compute_dtype)
    return tuple(torch.split(out, [i.numel() for i in ids_per_table]))
