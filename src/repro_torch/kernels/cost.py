"""The port's cost model of its kernels: for each kernel the operations,
bytes and special-function (MUFU) instructions its function needs, as
plain functions of shapes, dtypes and a plan; and the least time those
take on a card.

Each ``*_cost`` function returns a :class:`Cost` ``(operations, bytes,
special functions)``. Bytes count each input read once and each output
written once; operations are the function's own (a kernel that
recomputes something, as K2's second kernel does, pays for that itself).
Where the work depends on the data (the attention's live block pairs, the
run-sums' run counts), the caller passes the count its data gives; a
shape-only caller (the ``meta`` device, ``launch/dryrun.py``) passes the
upper bound, and says so.

:func:`bound_ms` turns a cost into the card's least time: the largest of
the operations at the dtype's peak, the bytes at the memory rate and the
special functions at the SFU rate. The peaks come from
``repro_torch.obs.PEAK_FLOPS`` (the card's cited figures by name), the
memory rate and SFU count below are the H100 SXM's specification figures.
``chip_smoke.py`` prints every kernel's bound from these functions.

:func:`record` hands a kernel's cost to the active analysis
(``launch/op_analysis.py``), if one is active: the wrappers call it on
``meta`` tensors (shapes only, the worst case) and, while an analysis is
active, where they launch (the live count).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

#: HBM3 bandwidth of the H100 80GB SXM (NVIDIA H100 datasheet, SXM5
#: column: 3.35 TB/s), bytes per second. A specification figure.
PEAK_BYTES = 3.35e12
#: Special-function (MUFU) instructions per clock: 16 per SM (Hopper's
#: SFUs) on 132 SMs (H100 SXM5). The clock is the card's maximum SM clock.
SFU_PER_CLOCK = 16 * 132
#: Special-function instructions the attention's function needs, derived
#: from its math (not read from the kernels' code, which may do more), by
#: what they depend on. Per score entry and head: SiLU's exp (EX2) and
#: reciprocal (RCP), and in the functional mode the bias's two exps,
#: z^rho = exp(rho * ln z) and exp(-z^rho). Per (query, key) pair, once for
#: all heads: the time bucket's division (RCP); logf, precise, is a
#: polynomial on the FMA pipe, and ln z = ln(dt + eps) - ln sigma needs no
#: division per entry (1/sigma and ln sigma are per head). K2 needs each
#: entry's bias and SiLU' once, so its counts are the same.
MUFU_PER_ENTRY_HEAD = {"bucket": 2, "functional": 4}
MUFU_PER_PAIR = {"bucket": 1, "functional": 0}
#: The attention kernels' block (``KERNEL_BLOCK``): a live block pair holds
#: BLOCK² (query, key) pairs.
BLOCK = 128
#: The dtype of the operations each kernel's bound is taken at: the
#: attention's is its operands' (bf16 or fp32), given by the caller.
PEAK_DTYPE = {"neg_fwd": "float16", "neg_bwd": "float16",
              "wscatter": "float32", "runsum": "float32",
              "neg_logits_fwd": "bfloat16", "neg_logits_bwd": "bfloat16",
              "gather": "bfloat16"}


class Cost(NamedTuple):
    operations: int
    bytes: int
    special: int = 0


def bound_ms(cost: Sequence[float], peak_flops: float,
             sm_clock_hz: Optional[float] = None
             ) -> Tuple[float, str, Dict[str, float]]:
    """(the least time in ms, the name of the term that binds, every
    term): operations at ``peak_flops``, bytes at :data:`PEAK_BYTES`,
    special functions at :data:`SFU_PER_CLOCK` × ``sm_clock_hz`` (a cost
    with special functions needs the clock)."""
    ops, byts = cost[0], cost[1]
    mufu = cost[2] if len(cost) > 2 else 0
    t = {"operations": ops / peak_flops * 1e3,
         "bytes": byts / PEAK_BYTES * 1e3}
    if mufu or sm_clock_hz is not None:
        if sm_clock_hz is None:
            raise ValueError("a cost with special functions needs the SM "
                             "clock")
        t["special functions"] = mufu / (SFU_PER_CLOCK * sm_clock_hz) * 1e3
    by = max(t, key=t.get)
    return t[by], by, t


# --------------------------------------------------------------------------
# the attention (K1-fwd, its append launch, K2; K8 is their dense grid)
# --------------------------------------------------------------------------

def attn_mufu(n_live: int, H: int, mode: str) -> int:
    """Special-function instructions of the entries of ``n_live`` live
    block pairs (BLOCK² pairs of a query and a key each, H heads a
    pair)."""
    pairs = BLOCK * BLOCK * n_live
    return pairs * (H * MUFU_PER_ENTRY_HEAD[mode] + MUFU_PER_PAIR[mode])


def plan_live_pairs(plan) -> int:
    """The live block pairs of a plan: the count its data gives, or on
    ``meta`` (no data) its padded work list, every pack's every entry (the
    plan's bound of every row at full length)."""
    if plan.n_live.device.type == "meta":
        return int(plan.q_wl.shape[:-1].numel())
    return int(plan.n_live.sum())


def _plan_bytes(plan, bwd: bool) -> int:
    n = plan.meta_i32.numel() + plan.meta_f32.numel()
    n += plan.q_wl.numel() + plan.q_rowptr.numel()
    if bwd:
        n += plan.kv_wl.numel() + plan.kv_rowptr.numel()
    return 4 * n


def attn_fwd_cost(plan, G: int, capp: int, H: int, D: int, itemsize: int,
                  mode: str, n_live: int, ntb: Optional[int] = None,
                  npb: int = 256) -> Cost:
    """K1-fwd: 4·b²·D operations per live block pair and head; q, k, v read
    and out written once, the plan, and the position and time tables
    (``npb`` and ``ntb`` rows of H; ``ntb`` by default 3 in the functional
    mode, 32 in the bucket mode); the special functions of
    :func:`attn_mufu`. q is (G, capp, H, D)."""
    if ntb is None:
        ntb = 3 if mode == "functional" else 32
    flops = 4 * BLOCK * BLOCK * D * H * n_live
    byts = (4 * G * capp * H * D * itemsize          # q, k, v read, out
            + _plan_bytes(plan, False) + (npb + ntb) * H * 4)
    return Cost(flops, byts, attn_mufu(n_live, H, mode))


def attn_bwd_cost(plan, G: int, capp: int, H: int, D: int, itemsize: int,
                  mode: str, n_live: int, ntb: int, npb: int = 256) -> Cost:
    """K2: S, dP, dV, dK and dQ, 2·b²·D operations each per live pair and
    head, each entry's bias and SiLU' once (the kernel's recomputation of
    S, dP and the bias in its second kernel is its own choice and not
    counted); q, k, v, dy read and dq, dk, dv written once, the plan and
    both tables and their grads."""
    flops = 10 * BLOCK * BLOCK * D * H * n_live
    byts = (7 * G * capp * H * D * itemsize          # q k v dy in, 3 out
            + _plan_bytes(plan, True) + 2 * (npb + ntb) * H * 4)
    return Cost(flops, byts, attn_mufu(n_live, H, mode))


def attn_append_cost(rows_n: int, pref: Sequence[int], total: Sequence[int],
                     H: int, D: int, itemsize: int,
                     mode: str = "bucket") -> Cost:
    """K1-fwd's append launch, from the window's live (query, key) pairs:
    each live query at position i sees the i + 1 keys before and at it;
    4·D operations per pair and head, the special functions of each
    entry; bytes: the window's q read and output written, each row's K and
    V read over its T live keys, the rows' timestamps and 1/(pos+1), the
    tables."""
    pairs = append_live_pairs(pref, total)[0]
    flops = 4 * D * H * pairs
    byts = (2 * rows_n * H * D * itemsize               # q read, out written
            + 2 * sum(total) * H * D * itemsize         # K, V prefixes
            + 4 * sum(total) + 4 * max(total) + (256 + 32) * H * 4)
    mufu = pairs * (H * MUFU_PER_ENTRY_HEAD[mode] + MUFU_PER_PAIR[mode])
    return Cost(flops, byts, mufu)


def append_live_pairs(pref: Sequence[int], total: Sequence[int]
                      ) -> Tuple[int, int]:
    """(live (query, key) pairs, live queries) of an append window."""
    pairs = sum((T * (T + 1) - p * (p + 1)) // 2 for p, T in zip(pref, total))
    return pairs, sum(T - p for p, T in zip(pref, total))


# --------------------------------------------------------------------------
# the negative paths (K3, K4, K9) and the run-sums (K5, K6), the gather (K7)
# --------------------------------------------------------------------------

def _neg_small(T: int, R: int, D: int, n_perms: int, o_itemsize: int) -> int:
    return T * D * o_itemsize + T * R * 4 + n_perms * 4


def neg_fwd_cost(T: int, R: int, D: int, n_perms: int, *,
                 o_itemsize: int = 2, row_itemsize: int = 2) -> Cost:
    """K3 over T (padded) tokens: each of the T·R gathered rows read once,
    o, the ids and the sharing perms, pos and valid read and lse written;
    2 operations per element of a row (the dot)."""
    byts = (T * R * D * row_itemsize + _neg_small(T, R, D, n_perms,
                                                  o_itemsize) + 3 * T * 4)
    return Cost(2 * T * R * D, byts)


def neg_bwd_cost(T: int, R: int, D: int, n_perms: int, *,
                 o_itemsize: int = 2, row_itemsize: int = 2) -> Cost:
    """K4: K3's reads and lse and g, w (T, R), dout (T, D) fp32 and dpos
    written; 4 operations per element of a row (the dot again and dout's
    FMA)."""
    byts = (T * R * D * row_itemsize
            + _neg_small(T, R, D, n_perms, o_itemsize)
            + 4 * T * 4 + T * R * 4 + T * D * 4 + T * 4)
    return Cost(4 * T * R * D, byts)


def neg_logits_cost(T: int, R: int, D: int, n_itemsize: int, bwd: bool, *,
                    o_itemsize: int = 2) -> Cost:
    """K9: n read once (and dn written once in backward), o, g (backward)
    and the logits or do; 2 (forward) or 3 (backward, do's FMA and dn's
    product) operations per element of n."""
    if bwd:
        byts = (2 * T * R * D * n_itemsize + T * D * o_itemsize + T * R * 4
                + T * D * 4)
        return Cost(3 * T * R * D, byts)
    return Cost(2 * T * R * D, T * R * D * n_itemsize + T * D * o_itemsize
                + T * R * 4)


def runsum_cost(n: int, n_runs: int, D: int) -> Cost:
    """K6 over n sorted (id, row) slots in n_runs runs: the fp32 rows read
    once, one total written per run, the order (int64), the sorted ids and
    the run pointers read; one add per element."""
    byts = n * D * 4 + n_runs * D * 4 + n * 8 + n * 4 + (n_runs + 1) * 4
    return Cost(n * D, byts)


def wscatter_cost(T: int, n_neg: int, n: int, n_runs: int, D: int, *,
                  o_itemsize: int = 2) -> Cost:
    """K5 over n slots, the first n_neg negative ones given as w·o[t]·scale
    (o (T, D)), the rest ready fp32 rows: o, the weights, the ready rows,
    the order, the sorted ids and the run pointers read once, one total
    written per run; 3 operations per element of a negative row (two
    products and the add), one per element of a ready row."""
    byts = (T * D * o_itemsize + n_neg * 4 + (n - n_neg) * D * 4 + n * 8
            + n * 4 + (n_runs + 1) * 4 + n_runs * D * 4)
    return Cost(3 * n_neg * D + (n - n_neg) * D, byts)


def gather_cost(n: int, n_valid: int, D: int, *, table_itemsize: int = 4,
                out_itemsize: int = 2) -> Cost:
    """K7: the rows of the n_valid ids ≥ 0 read once, n rows written, the
    ids read; no operations (a cast)."""
    return Cost(0, n_valid * D * table_itemsize + n * D * out_itemsize
                + n * 4)


# --------------------------------------------------------------------------
# the active analysis
# --------------------------------------------------------------------------

#: The sinks :func:`record` hands costs to, innermost last. A plain list,
#: not a context variable: a backward pass on the card runs in autograd's
#: device thread, and its kernels' costs belong to the same analysis.
_SINKS: List[Callable[..., None]] = []


def active() -> bool:
    """Is an analysis collecting kernel costs?"""
    return bool(_SINKS)


def record(kernel: str, cost: Cost, *, worst_case: bool,
           peak_dtype: Optional[str] = None, **info) -> None:
    """Hand ``kernel``'s cost to the active analysis (none: nothing).
    ``worst_case``: the cost is the shape's upper bound (``meta``), not
    the data's count."""
    if _SINKS:
        _SINKS[-1](kernel, Cost(*cost), worst_case=worst_case,
                   peak_dtype=peak_dtype or PEAK_DTYPE.get(kernel), **info)


@contextlib.contextmanager
def collecting(sink: Callable[..., None]):
    """Send every :func:`record` to ``sink(kernel, cost, worst_case=...,
    peak_dtype=..., **info)`` while the block runs."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)
