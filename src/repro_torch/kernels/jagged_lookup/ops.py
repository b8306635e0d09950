"""Sorted run-sum deduplication of sparse (id, row) pairs and the scatters
built on it (the port of ``repro.kernels.jagged_lookup.ops``).

:func:`unique_pairs` sorts the pairs by id (the table-major regrouping) and
reduces each run of equal ids with K6 (``csrc/runsum.cu``) for CUDA tensors
or its plain version (``ref.run_totals_plain``) for CPU tensors: the
unique (id, grad-row) pairs the sparse optimizer consumes.
:func:`dedup_rows` lays the same totals out as the reference does (at each
run's last slot), and :func:`scatter_add_rows` and the ``"two_pass"``
:func:`scatter_add_weighted_rows` build dense (V, D) arrays from them:
test-size oracles, never on the port's training path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.jagged_lookup import ref as R

#: Launches of each kernel in this module, counted where the wrapper
#: launches it and nowhere else.
KERNEL_LAUNCHES: Dict[str, int] = {"runsum": 0}

#: Sort key of dropped (negative) ids: they sort last, in one run.
DROP_KEY = 2 ** 30

_CTAS_PER_SM = 8
_RUNSUM_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])


def _lib():
    lib = _build.load("runsum")
    if lib.runsum.argtypes is None:
        lib.runsum.argtypes = _RUNSUM_ARGTYPES
        lib.runsum.restype = ctypes.c_int
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"runsum kernel: {msg}")


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = max(1, min(n, sms * _CTAS_PER_SM))
    lib = _lib()
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


def _device_check(rows: torch.Tensor) -> bool:
    """True: launch the kernel; False: the plain version (CPU tensors)."""
    if rows.device.type not in ("cuda", "cpu"):
        raise ValueError(f"runsum: unsupported device {rows.device}")
    return rows.device.type == "cuda"


def run_totals(rows: torch.Tensor, order: torch.Tensor, sids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (ids (u,) int32 ascending, totals (u, D) fp32), one per run of
    ids ≥ 0 (the dropped run left out), the plain version for CPU tensors.
    One host sync reads the run count, so the output is allocated at its
    size."""
    rows = rows.float().contiguous()
    if sids.numel() == 0:
        return sids, rows
    starts, num_runs = run_starts(sids)
    n_runs, dropped = torch.cat([num_runs, (sids[-1:] >= DROP_KEY).to(
        torch.int32)]).tolist()
    ids = sids[starts[:n_runs].long()]
    if _device_check(rows):
        out = rows.new_empty((n_runs, rows.shape[1]))
        _launch_runsum(rows, order, sids, starts, num_runs, out)
    else:
        out = R.run_totals_plain(rows, order, sids, n_runs, DROP_KEY)
    u = n_runs - dropped
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


def check_scatter_impl(impl: str) -> None:
    """Only ``"two_pass"`` runs; ``"fused"`` raises rather than quietly
    running two-pass."""
    if impl == "fused":
        raise NotImplementedError(
            "scatter_impl='fused' needs K5 (weighted_runsum_scatter), "
            "which is not ported yet: ROADMAP queue 1, item 1 (K5 and "
            "'fused' as the port's default); pass scatter_impl='two_pass'")
    if impl != "two_pass":
        raise ValueError(f"unknown scatter impl {impl!r}")


def scatter_add_weighted_rows(weights: torch.Tensor, o: torch.Tensor,
                              ids: torch.Tensor, vocab: int, *,
                              scale: float = 1.0,
                              impl: str = "fused") -> torch.Tensor:
    """Σ over (t, r) of ``weights[t, r] · o[t] · scale`` per id → (V, D).

    ``impl="two_pass"`` builds every row, then :func:`scatter_add_rows`.
    ``impl="fused"`` (the reference's default: rows generated inside the
    weighted run-sum scatter, K5) is not ported yet."""
    check_scatter_impl(impl)
    T, R = weights.shape
    ids = ids.reshape(-1)
    valid = (ids >= 0) & (ids < vocab)
    # the two-pass rows w[t, r]·(o[t]·scale), t-major: the reference's order
    rows = (weights.float()[:, :, None]
            * (o.float() * scale)[:, None, :]).reshape(T * R, o.shape[1])
    return scatter_add_rows(rows, torch.where(valid, ids, -1), vocab)
