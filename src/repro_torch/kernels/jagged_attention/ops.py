"""Jagged pointwise attention + RAB: the plan, the kernel's wrapper, and
the plan-aware ``attn_fn`` the model stack calls.

All per-call metadata (token meta, per-block segment ranges, both
destination-ordered work-lists of live (q-block, k-block) pairs, and the
CSR run pointers the CUDA kernels walk) lives in a :class:`JaggedAttnPlan`.
The plan depends only on (offsets, timestamps, capacity, block),
so the model builds it once per micro-batch and every layer reuses it.
Every helper takes one pack (offsets ``(S+1,)``) or G packs at once
(offsets ``(G, S+1)``); the G packs of a serving micro-batch go to the
kernel in one launch.

The core is a ``torch.autograd.Function``: its forward is K1-fwd
(``csrc/jagged_attn_fwd.cu``), its backward K2 (``csrc/jagged_attn_bwd.cu``,
the grads of q, k, v and both RAB tables). ``schedule="dense"`` selects
K8, their launch variants that walk the dense (nb, nb) block grid and skip
dead pairs by the plan's per-block segment ranges (the reference's
oracle schedule); it is chosen by the caller, never as a fallback. Both
schedules compute one function, so they share the plain versions. Both
take either time mode:
HSTU's bucket table, or FuXi's functional encoder, whose raw parameters
(amp, log σ, the ρ logit) :func:`run_attention` packs into a (3, H)
``[amp; σ; ρ]`` in plain differentiable torch, so autograd carries the
kernel's d(amp, σ, ρ) back to them. Dispatch is by where the tensors
lie: CUDA tensors launch the hand-written kernels or raise; CPU tensors
take the plain PyTorch versions in ``ref.py``. There is no fallback between
the two.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import RABConfig
from repro_torch.core.jagged import NEG_SEG
from repro_torch.kernels import _build
from repro_torch.kernels.jagged_attention import ref as R

#: Launches of each kernel in this module, counted where the wrapper
#: launches it and nowhere else: ``attn_fwd``/``attn_bwd`` (K1-fwd, K2) in
#: the bucket time mode, ``*_functional`` in the functional one,
#: ``attn_*_dense*`` the dense-grid schedule (K8) in either mode, and
#: ``attn_fwd_append*`` K1-fwd's append launch (the serving warm window).
KERNEL_LAUNCHES: Dict[str, int] = {
    f"attn_{kind}{sched}{mode}": 0 for kind in ("fwd", "bwd")
    for sched in ("", "_dense") for mode in ("", "_functional")}
KERNEL_LAUNCHES.update({f"attn_fwd_append{mode}": 0
                        for mode in ("", "_functional")})
TIME_MODES = ("bucket", "functional")
SCHEDULES = ("worklist", "dense")


def launch_counter(kind: str, *, dense: bool, functional: bool) -> str:
    """The ``KERNEL_LAUNCHES`` key of a ``kind`` ("fwd"/"bwd", or
    "fwd_append" with ``dense`` False) launch."""
    return (f"attn_{kind}{'_dense' if dense else ''}"
            f"{'_functional' if functional else ''}")


def check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of "
                         f"{SCHEDULES}")

#: Row tile of the CUDA kernel: it takes plans built with this block only.
KERNEL_BLOCK = 128
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def _token_meta(cap: int, offsets: torch.Tensor, timestamps: torch.Tensor):
    """(meta_i32 (…, cap, 3): seg/pos/ts, meta_f32 (…, cap, 1): per-query
    1/(pos+1), the count of keys each query sees)."""
    offsets = offsets.to(torch.int32).contiguous()
    slot = torch.arange(cap, dtype=torch.int32, device=offsets.device)
    slot = slot.expand(*offsets.shape[:-1], cap).contiguous()
    seg = (torch.searchsorted(offsets, slot, right=True) - 1).to(torch.int32)
    valid = slot < offsets[..., -1:]
    segc = seg.clamp(0, offsets.shape[-1] - 2).long()
    pos = slot - torch.gather(offsets, -1, segc)
    n = (pos + 1).to(torch.float32)
    seg = torch.where(valid, seg, NEG_SEG)
    pos = torch.where(valid, pos, 0)
    ninv = torch.where(valid, 1.0 / n, 0.0)
    meta_i32 = torch.stack([seg, pos, timestamps.to(torch.int32)], dim=-1)
    return meta_i32, ninv[..., None]


def _seg_ranges(seg: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """Per-block (min valid seg, max seg): (…, nb, 2) int32."""
    s = seg.reshape(*seg.shape[:-1], nb, block)
    big = 2 ** 30
    lo = torch.where(s >= 0, s, big).amin(-1)
    hi = s.amax(-1)
    lo = torch.where(hi >= 0, lo, big)
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def _live_block_matrix(seg_rng: torch.Tensor, block: int) -> torch.Tensor:
    """(…, nb, nb) bool [qb, kb]: does the pair hold any live token pair?
    Exact: packed segments are contiguous, so intersecting [lo, hi] ranges
    share a segment, and the causal band (i+1)·b−1 ≥ j·b means i ≥ j."""
    nb = seg_rng.shape[-2]
    lo, hi = seg_rng[..., 0], seg_rng[..., 1]
    live = ((lo[..., :, None] <= hi[..., None, :])
            & (lo[..., None, :] <= hi[..., :, None])
            & (hi[..., :, None] >= 0) & (hi[..., None, :] >= 0))
    i = torch.arange(nb, dtype=torch.int32, device=seg_rng.device)
    return live & (((i[:, None] + 1) * block - 1) >= (i[None, :] * block))


def _compact_worklist(live: torch.Tensor, n_pairs: int, *,
                      kv_major: bool = False):
    """Compact a live matrix into ((…, L, 2) pairs, (…, L, 2) flags, (…, L)
    mask, (…,) live count), destination-major, one pair per step.

    Entries past the live count replicate the last live pair (an
    all-padding pack clamps to pair (0, 0) with the mask 0), so the
    destination id never decreases along the list. flags mark the first
    and last entry of each destination run. Equal, field for field, to the
    JAX package's list at ``pairs_per_step=1``, whose length L is the
    static pair bound ``n_pairs``."""
    nb = live.shape[-1]
    L = n_pairs
    flat = (live.transpose(-1, -2) if kv_major else live)
    flat = flat.reshape(*live.shape[:-2], nb * nb)
    order = torch.argsort((~flat).to(torch.int8), dim=-1, stable=True)
    n_live = flat.to(torch.int64).sum(-1).clamp(max=n_pairs)
    pos = torch.arange(L, dtype=torch.int64, device=live.device)
    entries = torch.where(pos < n_live[..., None], order[..., :L], -1)
    fillsrc = torch.cummax(torch.where(entries >= 0, pos, -1), dim=-1).values
    v = torch.gather(entries, -1, fillsrc.clamp(min=0)).clamp(min=0)
    major, minor = v // nb, v % nb
    pairs = (torch.stack([minor, major], dim=-1) if kv_major
             else torch.stack([major, minor], dim=-1))
    live_mask = (entries >= 0).to(torch.int32)
    change = major[..., 1:] != major[..., :-1]
    one = torch.ones_like(major[..., :1], dtype=torch.bool)
    first = torch.cat([one, change], dim=-1)
    last = torch.cat([change, one], dim=-1)
    flags = torch.stack([first, last], dim=-1).to(torch.int32)
    return pairs.to(torch.int32), flags, live_mask, n_live.to(torch.int32)


def _run_pointers(dest: torch.Tensor, live: torch.Tensor,
                  nb: int) -> torch.Tensor:
    """CSR run pointers (…, nb+1) over a destination-major list (``dest``
    (…, L) the destination block of each entry): the live pairs of block b
    are entries [ptr[b], ptr[b+1]). Live entries form a prefix sorted by
    destination, so the runs are the per-block live counts."""
    counts = torch.zeros((*dest.shape[:-1], nb), dtype=torch.int64,
                         device=dest.device)
    counts.scatter_add_(-1, dest.long(), live.long())
    zero = torch.zeros_like(counts[..., :1])
    return torch.cat([zero, counts.cumsum(-1)], dim=-1).to(torch.int32)


def num_pairs_bound(nb: int, block: int, num_rows: int,
                    max_row_len: Optional[int]) -> int:
    """Static worst-case live-pair count: a row of at most max_row_len
    tokens straddles at most mr = ceil(max_row_len/block)+1 blocks."""
    dense = nb * (nb + 1) // 2
    if max_row_len is None:
        return max(1, dense)
    mr = min(-(-max_row_len // block) + 1, nb)
    per_row = mr * (mr + 1) // 2
    return max(1, min(num_rows * per_row, dense))


class JaggedAttnPlan(NamedTuple):
    """Per-micro-batch attention metadata, built once and reused by every
    layer. Fields carry a leading G axis when the plan covers G packs.

    ``q_wl``/``kv_wl`` enumerate exactly the live (qb, kb) block pairs,
    q-block-major and k-block-major; entries past ``n_live`` are dead
    padding (``q_live``/``kv_live`` 0). ``q_rowptr`` and ``kv_rowptr``
    hold the CSR run pointers over ``q_wl`` and ``kv_wl`` that the kernels
    walk: one CTA per q-block (forward, dq) or k-block (dk, dv). Rows
    longer than the ``max_row_len`` the plan was built with would overflow
    the static list and drop pairs; the model passes ``cfg.max_seq_len``.
    """
    meta_i32: torch.Tensor      # (cap, 3) int32: seg / pos / ts
    meta_f32: torch.Tensor      # (cap, 1) f32: 1/n
    seg_rng: torch.Tensor       # (nb, 2) int32 per-block segment ranges
    q_wl: torch.Tensor          # (L, 2) int32 (qb, kb), q-block-major
    q_flags: torch.Tensor       # (L, 2) int32 first/last of each qb run
    q_live: torch.Tensor        # (L,) int32 1 = real entry
    kv_wl: torch.Tensor         # (L, 2) int32 (qb, kb), k-block-major
    kv_flags: torch.Tensor      # (L, 2) int32 first/last of each kb run
    kv_live: torch.Tensor       # (L,) int32 1 = real entry
    n_live: torch.Tensor        # (1,) int32 live-pair count
    q_rowptr: torch.Tensor      # (nb+1,) int32 CSR runs over q_wl
    kv_rowptr: torch.Tensor     # (nb+1,) int32 CSR runs over kv_wl

    @property
    def capacity(self) -> int:
        return self.meta_i32.shape[-2]

    @property
    def num_blocks(self) -> int:
        return self.seg_rng.shape[-2]

    @property
    def block(self) -> int:
        return self.capacity // self.num_blocks

    @property
    def num_pairs(self) -> int:
        return self.q_wl.shape[-2]

    @property
    def batched(self) -> bool:
        return self.meta_i32.dim() == 3


def build_attn_plan(offsets: torch.Tensor, timestamps: torch.Tensor,
                    capacity: int, *, block: int = 128,
                    max_row_len: Optional[int] = None) -> JaggedAttnPlan:
    """Build the plan on the tensors' device. ``capacity`` may be any size
    ≥ offsets[-1]; it is padded up to a block multiple. ``max_row_len``
    tightens the work-list bound from O(nb²) to O(rows · blocks_per_row²).
    offsets (S+1,) with timestamps (cap,), or (G, S+1) with (G, cap)."""
    pad = (-capacity) % block
    capp = capacity + pad
    timestamps = timestamps.to(torch.int32)
    if pad:
        timestamps = torch.cat(
            [timestamps,
             timestamps.new_zeros((*timestamps.shape[:-1], pad))], dim=-1)
    meta_i32, meta_f32 = _token_meta(capp, offsets, timestamps)
    nb = capp // block
    seg_rng = _seg_ranges(meta_i32[..., 0], nb, block)
    live = _live_block_matrix(seg_rng, block)
    P = num_pairs_bound(nb, block, offsets.shape[-1] - 1, max_row_len)
    q_wl, q_flags, q_live, n_live = _compact_worklist(live, P)
    kv_wl, kv_flags, kv_live, _ = _compact_worklist(live, P, kv_major=True)
    return JaggedAttnPlan(
        meta_i32=meta_i32, meta_f32=meta_f32, seg_rng=seg_rng,
        q_wl=q_wl, q_flags=q_flags, q_live=q_live,
        kv_wl=kv_wl, kv_flags=kv_flags, kv_live=kv_live,
        n_live=n_live[..., None],
        q_rowptr=_run_pointers(q_wl[..., 0], q_live, nb),
        kv_rowptr=_run_pointers(kv_wl[..., 1], kv_live, nb))


def _as_batched(plan: JaggedAttnPlan) -> JaggedAttnPlan:
    if plan.batched:
        return plan
    return JaggedAttnPlan(*(f.unsqueeze(0) for f in plan))


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

_FWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_TB_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def time_bucket_denom(tb_scale: float) -> float:
    """log(10)·scale in fp32, as the TPU kernel computes it; the bucket is
    floor(log(1+dt) / denom) in fp32 on every path of this module."""
    return float(np.float32(math.log(10.0)) * np.float32(tb_scale))


_APPEND_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                    + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])


def _kernel_lib():
    lib = _build.load("jagged_attn_fwd")
    if lib.jagged_attn_fwd.argtypes is None:
        lib.jagged_attn_fwd.argtypes = _FWD_ARGTYPES
        lib.jagged_attn_fwd.restype = ctypes.c_int
        lib.jagged_attn_fwd_append.argtypes = _APPEND_ARGTYPES
        lib.jagged_attn_fwd_append.restype = ctypes.c_int
        lib.jagged_attn_time_buckets.argtypes = _TB_ARGTYPES
        lib.jagged_attn_time_buckets.restype = ctypes.c_int
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"jagged_attn_fwd kernel: {msg}")


def _check_time_table(time_table, time_functional: bool) -> None:
    _require(not time_functional or time_table.shape[0] == 3,
             f"functional time mode takes the packed (3, H) [amp; sigma; "
             f"rho], got {tuple(time_table.shape)}")


def _launch_fwd(q, k, v, pos_table, time_table, plan: JaggedAttnPlan, *,
                scale: float, tb_denom: float, use_pos: bool,
                use_time: bool, time_functional: bool = False,
                dense: bool = False) -> torch.Tensor:
    """Launch the CUDA forward on q, k, v (G, capp, H, D) and a batched
    plan: K1-fwd over the work-list, or with ``dense`` K8-fwd over the
    dense block grid; raises on anything the kernel does not take."""
    G, capp, H, D = q.shape
    dev = q.device
    _require(dev.type == "cuda", f"tensors on {dev}, not on the card")
    _require(q.dtype in _DTYPE_CODE,
             f"dtype {q.dtype}; takes float32 or bfloat16")
    for name, t in (("k", k), ("v", v)):
        _require(t.shape == q.shape and t.dtype == q.dtype
                 and t.device == dev, f"{name} {tuple(t.shape)} {t.dtype} "
                 f"does not match q {tuple(q.shape)} {q.dtype}")
    _require(D in KERNEL_HEAD_DIMS, f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    _require(plan.block == KERNEL_BLOCK,
             f"plan block {plan.block}; the kernel tiles {KERNEL_BLOCK} rows")
    _require(plan.capacity == capp and plan.meta_i32.shape[0] == G,
             f"plan for {plan.meta_i32.shape[0]} x {plan.capacity} tokens, "
             f"call has {G} x {capp}")
    for name, t in (("pos_table", pos_table), ("time_table", time_table)):
        _require(t.dtype == torch.float32 and t.dim() == 2
                 and t.shape[1] == H and t.device == dev,
                 f"{name} must be (n, {H}) float32 on {dev}")
    _check_time_table(time_table, time_functional)
    for name, dtype in (("meta_i32", torch.int32), ("meta_f32", torch.float32),
                        ("q_wl", torch.int32), ("q_rowptr", torch.int32),
                        ("seg_rng", torch.int32)):
        t = getattr(plan, name)
        _require(t.device == dev and t.dtype == dtype,
                 f"plan.{name} is {t.dtype} on {t.device}")
    tensors = [q, k, v, pos_table, time_table, plan.meta_i32,
               plan.meta_f32, plan.q_wl, plan.q_rowptr, plan.seg_rng]
    _require(all(t.is_contiguous() for t in tensors), "inputs must be "
             "contiguous")
    # the bf16 kernel copies rows in by 16-byte cp.async
    _require(q.dtype != torch.bfloat16
             or all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
             "bf16 q, k and v must be 16-byte aligned")
    out = torch.empty_like(v)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.jagged_attn_fwd(
            *(t.data_ptr() for t in tensors), out.data_ptr(),
            G, capp, H, D, plan.num_pairs, pos_table.shape[0],
            time_table.shape[0], scale, tb_denom, int(use_pos),
            int(use_time), int(time_functional), int(dense),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jagged_attn_fwd launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES[launch_counter("fwd", dense=dense,
                                   functional=time_functional)] += 1
    return out


def position_ninv(capacity: int, device) -> torch.Tensor:
    """(capacity,) fp32 1/(i+1) at position i: the plan's per-query count
    (``_token_meta``) by the same expression, so the append launch reads
    the bits the cold launch reads."""
    n = (torch.arange(capacity, dtype=torch.int32, device=device)
         + 1).to(torch.float32)
    return 1.0 / n


def _launch_append(q, k_cache, v_cache, rows, timestamps, prefix_len,
                   total_len, pos_table, time_table, ninv, *, scale: float,
                   tb_denom: float, use_pos: bool, use_time: bool,
                   time_functional: bool = False) -> torch.Tensor:
    """Launch K1-fwd's append variant: the window q (R, Q, H, D) against
    the layer's cache (N+1, cap, H, D) at slots ``rows``; raises on
    anything the kernel does not take."""
    R, Q, H, D = q.shape
    dev = q.device
    _require(dev.type == "cuda", f"tensors on {dev}, not on the card")
    _require(q.dtype in _DTYPE_CODE,
             f"dtype {q.dtype}; takes float32 or bfloat16")
    _require(k_cache.dim() == 4 and k_cache.shape[2:] == (H, D)
             and v_cache.shape == k_cache.shape,
             f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} do "
             f"not match q {tuple(q.shape)}")
    cap = k_cache.shape[1]
    _require(cap % KERNEL_BLOCK == 0,
             f"cache rows of {cap}; the kernel tiles {KERNEL_BLOCK}")
    _require(D in KERNEL_HEAD_DIMS, f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _require(t.dtype == q.dtype and t.device == dev,
                 f"{name} {t.dtype} on {t.device}, q {q.dtype} on {dev}")
    for name, t in (("pos_table", pos_table), ("time_table", time_table)):
        _require(t.dtype == torch.float32 and t.dim() == 2
                 and t.shape[1] == H and t.device == dev,
                 f"{name} must be (n, {H}) float32 on {dev}")
    _check_time_table(time_table, time_functional)
    for name, t, shape in (("rows", rows, (R,)), ("prefix_len", prefix_len,
                                                   (R,)),
                           ("total_len", total_len, (R,)),
                           ("timestamps", timestamps, (R, cap))):
        _require(t.dtype == torch.int32 and tuple(t.shape) == shape
                 and t.device == dev, f"{name} must be {shape} int32 on "
                 f"{dev}, got {tuple(t.shape)} {t.dtype}")
    _require(ninv.dtype == torch.float32 and tuple(ninv.shape) == (cap,)
             and ninv.device == dev, f"ninv must be ({cap},) float32")
    tensors = [q, k_cache, v_cache, pos_table, time_table, rows, prefix_len,
               total_len, timestamps, ninv]
    _require(all(t.is_contiguous() for t in tensors), "inputs must be "
             "contiguous")
    _require(q.dtype != torch.bfloat16
             or all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)),
             "bf16 q and the caches must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        rc = lib.jagged_attn_fwd_append(
            *(t.data_ptr() for t in tensors), out.data_ptr(),
            R, Q, cap, H, D, pos_table.shape[0], time_table.shape[0],
            scale, tb_denom, int(use_pos), int(use_time),
            int(time_functional), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jagged_attn_fwd_append launch failed: CUDA "
                           f"error {rc}")
    KERNEL_LAUNCHES[launch_counter("fwd_append", dense=False,
                                   functional=time_functional)] += 1
    return out


def attention_append(q, k_cache, v_cache, rows, timestamps, prefix_len,
                     total_len, pos_table, time_table, ninv, *, scale: float,
                     tb_denom: float, use_pos: bool, use_time: bool,
                     time_functional: bool = False) -> torch.Tensor:
    """K1-fwd's append launch for card tensors, its plain version
    (``ref.attention_append_plain``) for CPU tensors: the warm window's
    queries q (R, Q, H, D) at rows [p_r, p_r + Q) of slot ``rows[r]``
    against keys [0, p_r + Q) of the layer's cache (N+1, cap, H, D), with
    ``total_len`` T_r = p_r + n_r live tokens; each live query gets the
    bits of the cold work-list launch on its row. → (R, Q, H, D), 0 at
    window rows at or past T_r. Forward only (serving)."""
    kw = dict(scale=scale, tb_denom=tb_denom, use_pos=use_pos,
              use_time=use_time, time_functional=time_functional)
    if q.device.type == "cuda":
        return _launch_append(q, k_cache, v_cache, rows, timestamps,
                              prefix_len, total_len, pos_table, time_table,
                              ninv, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"append attention: unsupported device {q.device}")
    return R.attention_append_plain(q, k_cache, v_cache, rows, timestamps,
                                    prefix_len, total_len, pos_table,
                                    time_table, ninv, block=KERNEL_BLOCK,
                                    **kw)


def kernel_time_buckets(qts: torch.Tensor, kts: torch.Tensor,
                        tb_scale: float, num_buckets: int) -> torch.Tensor:
    """(nq, nk) int32 time buckets of every (q, k) timestamp pair, from the
    same device function the forward kernel uses — for holding the kernel's
    bucket arithmetic against the plain version's on the card."""
    _require(qts.is_cuda and kts.is_cuda, "time buckets need card tensors")
    qts = qts.to(torch.int32).contiguous()
    kts = kts.to(torch.int32).contiguous()
    out = torch.empty((qts.numel(), kts.numel()), dtype=torch.int32,
                      device=qts.device)
    lib = _kernel_lib()
    with torch.cuda.device(qts.device):
        rc = lib.jagged_attn_time_buckets(
            qts.data_ptr(), qts.numel(), kts.data_ptr(), kts.numel(),
            time_bucket_denom(tb_scale), num_buckets, out.data_ptr(),
            torch.cuda.current_stream(qts.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jagged_attn_time_buckets failed: CUDA error {rc}")
    return out


_BWD_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                 + [ctypes.c_float] * 2 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


def _bwd_lib():
    lib = _build.load("jagged_attn_bwd")
    if lib.jagged_attn_bwd.argtypes is None:
        lib.jagged_attn_bwd.argtypes = _BWD_ARGTYPES
        lib.jagged_attn_bwd.restype = ctypes.c_int
    return lib


def _launch_bwd(q, k, v, dy, pos_table, time_table, plan: JaggedAttnPlan,
                *, scale: float, tb_denom: float, use_pos: bool,
                use_time: bool, time_functional: bool = False,
                dense: bool = False):
    """Launch K2 (the dk/dv kernel, the dq + RAB-partials kernel and the
    fixed-order sum of the per-CTA RAB partials) on a batched plan, or with
    ``dense`` K8-bwd (the same three over the dense block grid); raises on
    anything the kernels do not take. → (dq, dk, dv, dpt, dtt); in the
    functional time mode dtt is d(amp, σ, ρ) (3, H)."""
    G, capp, H, D = q.shape
    dev = q.device
    _require(dev.type == "cuda", f"tensors on {dev}, not on the card")
    _require(q.dtype in _DTYPE_CODE,
             f"dtype {q.dtype}; takes float32 or bfloat16")
    for name, t in (("k", k), ("v", v), ("dy", dy)):
        _require(t.shape == q.shape and t.dtype == q.dtype
                 and t.device == dev, f"{name} {tuple(t.shape)} {t.dtype} "
                 f"does not match q {tuple(q.shape)} {q.dtype}")
    _require(D in KERNEL_HEAD_DIMS, f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    _require(plan.block == KERNEL_BLOCK,
             f"plan block {plan.block}; the kernel tiles {KERNEL_BLOCK} rows")
    _require(plan.capacity == capp and plan.meta_i32.shape[0] == G,
             f"plan for {plan.meta_i32.shape[0]} x {plan.capacity} tokens, "
             f"call has {G} x {capp}")
    for name, t in (("pos_table", pos_table), ("time_table", time_table)):
        _require(t.dtype == torch.float32 and t.dim() == 2
                 and t.shape[1] == H and t.device == dev,
                 f"{name} must be (n, {H}) float32 on {dev}")
    _check_time_table(time_table, time_functional)
    for name in ("meta_i32", "meta_f32", "q_wl", "q_rowptr", "kv_wl",
                 "kv_rowptr", "seg_rng"):
        t = getattr(plan, name)
        _require(t.device == dev and t.dtype in (torch.int32, torch.float32),
                 f"plan.{name} is {t.dtype} on {t.device}")
    npb, ntb = pos_table.shape[0], time_table.shape[0]
    nb = capp // KERNEL_BLOCK
    tensors = [q, k, v, dy, pos_table, time_table, plan.meta_i32,
               plan.meta_f32, plan.q_wl, plan.q_rowptr, plan.kv_wl,
               plan.kv_rowptr, plan.seg_rng]
    _require(all(t.is_contiguous() for t in tensors), "inputs must be "
             "contiguous")
    # the bf16 kernels copy q, k, v and dy rows in 16-byte pieces
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v, dy)),
             "q, k, v and dy must be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # one (npb + ntb)-wide partial per dq CTA (64-row q chunk, head, pack)
    partial = torch.empty((G * 2 * nb * H, npb + ntb), dtype=torch.float32,
                          device=dev)
    dpt = torch.empty((npb, H), dtype=torch.float32, device=dev)
    dtt = torch.empty((ntb, H), dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        rc = lib.jagged_attn_bwd(
            *(t.data_ptr() for t in tensors),
            *(t.data_ptr() for t in (dq, dk, dv, partial, dpt, dtt)),
            G, capp, H, D, plan.num_pairs, npb, ntb, scale, tb_denom,
            int(use_pos), int(use_time), int(time_functional), int(dense),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"jagged_attn_bwd launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES[launch_counter("bwd", dense=dense,
                                   functional=time_functional)] += 1
    return dq, dk, dv, dpt, dtt


class _AttnCore(torch.autograd.Function):
    """The kernels of ``schedule`` (K1-fwd/K2 for "worklist", K8 for
    "dense"), or with ``schedule=None`` the plain versions, which serve
    both. The plan and the static settings ride along as non-tensor
    arguments."""

    @staticmethod
    def forward(ctx, q, k, v, pos_table, time_table, plan, kw, schedule):
        if schedule is None:
            out = R.attention_fwd_plain(q, k, v, pos_table, time_table, plan,
                                        **kw)
        else:
            out = _launch_fwd(q, k, v, pos_table, time_table, plan,
                              dense=schedule == "dense", **kw)
        ctx.save_for_backward(q, k, v, pos_table, time_table)
        ctx.plan, ctx.kw, ctx.schedule = plan, kw, schedule
        return out

    @staticmethod
    def backward(ctx, dy):
        q, k, v, pt, tt = ctx.saved_tensors
        plan, kw = ctx.plan, ctx.kw
        dy = _masked(plan.meta_i32, dy).contiguous()
        if ctx.schedule is None:
            grads = R.attention_bwd_plain(q, k, v, dy, pt, tt, plan, **kw)
        else:
            grads = _launch_bwd(q, k, v, dy, pt, tt, plan,
                                dense=ctx.schedule == "dense", **kw)
        dq, dk, dv, dpt, dtt = grads
        dq, dk, dv = (_masked(plan.meta_i32, t) for t in (dq, dk, dv))
        dpt = dpt if kw["use_pos"] else torch.zeros_like(pt)
        dtt = dtt if kw["use_time"] else torch.zeros_like(tt)
        return dq, dk, dv, dpt, dtt, None, None, None


def attention_core(q, k, v, pos_table, time_table, plan: JaggedAttnPlan, *,
                   schedule: str = "worklist", **kw) -> torch.Tensor:
    """The kernels of ``schedule`` for card tensors, the plain versions for
    CPU tensors; differentiable in q, k, v and both tables."""
    check_schedule(schedule)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"jagged attention: unsupported device {q.device}")
    return _AttnCore.apply(q, k, v, pos_table, time_table, plan, kw,
                           schedule if q.device.type == "cuda" else None)


def plain_core(q, k, v, pos_table, time_table, plan: JaggedAttnPlan, *,
               schedule: str = "worklist", **kw) -> torch.Tensor:
    """The plain versions on any device, for either schedule (what a check
    calls to recompute a kernel result), differentiable like
    :func:`attention_core`."""
    check_schedule(schedule)
    return _AttnCore.apply(q, k, v, pos_table, time_table, plan, kw, None)


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------

def _masked(meta_i32: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Pad slots are defined to be zero, matching the oracles."""
    valid = (meta_i32[..., 0] >= 0)[..., None, None]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))


def functional_time_table(rab_params) -> torch.Tensor:
    """FuXi's time parameters as the kernels take them in the functional
    time mode: (3, H) fp32 ``[amp; exp(log σ); sigmoid(ρ logit)·1.5 +
    0.25]``, differentiable in the raw ``time_amp``, ``time_log_sigma`` and
    ``time_rho``."""
    f32 = {n: rab_params[n].to(torch.float32) for n in
           ("time_amp", "time_log_sigma", "time_rho")}
    return torch.stack([f32["time_amp"], torch.exp(f32["time_log_sigma"]),
                        torch.sigmoid(f32["time_rho"]) * 1.5 + 0.25])


def rab_tables(rab_params, rab: Optional[RABConfig], H: int, device,
               time_mode: str = "bucket"):
    """The kernels' RAB inputs: (pos_table, time_table, settings), the
    tables (n, H) fp32 (an (8, H) zero table where the config has none;
    in the functional time mode the packed ``[amp; σ; ρ]``) and the
    keywords ``tb_denom``, ``use_pos``, ``use_time``, ``time_functional``
    the kernels take beside ``scale``."""
    if time_mode not in TIME_MODES:
        raise ValueError(f"time_mode {time_mode!r} not in {TIME_MODES}")
    functional = time_mode == "functional"
    use_pos = bool(rab and rab.use_pos and "pos_table" in rab_params)
    use_time = bool(rab and rab.use_time and (
        "time_amp" if functional else "time_table") in rab_params)
    zeros = torch.zeros((8, H), dtype=torch.float32, device=device)
    pt = (rab_params["pos_table"].to(torch.float32).contiguous() if use_pos
          else zeros)
    if use_time and functional:
        tt = functional_time_table(rab_params)
    elif use_time:
        tt = rab_params["time_table"].to(torch.float32).contiguous()
    else:
        tt = zeros
    tb_scale = rab.time_bucket_scale if rab else 0.301
    return pt, tt, dict(tb_denom=time_bucket_denom(tb_scale),
                        use_pos=use_pos, use_time=use_time,
                        time_functional=functional and use_time)


def run_attention(q, k, v, offsets, timestamps, rab_params,
                  rab: Optional[RABConfig], *, core: Callable,
                  time_mode: str = "bucket", block: int = 128,
                  plan: Optional[JaggedAttnPlan] = None,
                  schedule: str = "worklist",
                  max_row_len: Optional[int] = None) -> torch.Tensor:
    """Shared body of :func:`jagged_attention` and the plain
    ``ref.jagged_attention_ref``: tables, padding, plan, ``core``, mask.
    In the functional time mode the kernels take
    :func:`functional_time_table`, built here, outside the autograd
    Function, as the reference builds it outside its custom VJP."""
    batched = q.dim() == 4
    if not batched:
        q, k, v = (t.unsqueeze(0) for t in (q, k, v))
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must match")
    G, cap, H, D = q.shape
    pt, tt, tkw = rab_tables(rab_params, rab, H, q.device, time_mode)
    pad = (-cap) % block
    if pad:
        zpad = q.new_zeros((G, pad, H, D))
        q, k, v = (torch.cat([t, zpad], dim=1) for t in (q, k, v))
    if plan is None:
        plan = build_attn_plan(offsets, timestamps, cap, block=block,
                               max_row_len=max_row_len)
    plan = _as_batched(plan)
    if (plan.capacity != cap + pad or plan.block != block
            or plan.meta_i32.shape[0] != G):
        raise ValueError(
            f"plan (packs={plan.meta_i32.shape[0]}, capacity="
            f"{plan.capacity}, block={plan.block}) does not match call "
            f"(packs={G}, capacity={cap + pad}, block={block})")
    out = core(q.contiguous(), k.contiguous(), v.contiguous(), pt, tt, plan,
               scale=1.0 / math.sqrt(D), schedule=schedule, **tkw)
    out = _masked(plan.meta_i32, out)[:, :cap]
    return out if batched else out[0]


def jagged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     offsets: torch.Tensor, timestamps: torch.Tensor,
                     rab_params, rab: Optional[RABConfig], *,
                     time_mode: str = "bucket", block: int = 128,
                     plan: Optional[JaggedAttnPlan] = None,
                     schedule: str = "worklist",
                     max_row_len: Optional[int] = None) -> torch.Tensor:
    """Fused jagged pointwise attention + RAB, forward, causal within each
    row. q, k, v (cap, H, D) with offsets (S+1,), or (G, cap, H, D) with
    offsets (G, S+1). ``time_mode`` "bucket" reads ``rab_params``'
    ``time_table``; "functional" its ``time_amp``, ``time_log_sigma`` and
    ``time_rho`` (FuXi). ``schedule`` "worklist" runs K1-fwd/K2 over the
    live-pair work-list, "dense" K8 over the dense block grid: the same
    function, bit for bit on one plan.

    ``plan`` reuses a :func:`build_attn_plan` result; it must match
    capacity and block (checked)."""
    return run_attention(q, k, v, offsets, timestamps, rab_params, rab,
                         core=attention_core, time_mode=time_mode,
                         block=block, plan=plan, schedule=schedule,
                         max_row_len=max_row_len)


# --------------------------------------------------------------------------
# attn_fn factory — plan-aware callable for the model stack
# --------------------------------------------------------------------------

class PlannedAttention:
    """attn_fn with one plan per micro-batch (models/gr.py detects
    ``make_plan`` and builds the plan once, outside the layer loop)."""

    def __init__(self, *, block: int = 128, schedule: str = "worklist",
                 max_row_len: Optional[int] = None):
        check_schedule(schedule)
        self.block = block
        self.schedule = schedule
        self.max_row_len = max_row_len

    def make_plan(self, offsets: torch.Tensor, timestamps: torch.Tensor,
                  capacity: int) -> JaggedAttnPlan:
        return build_attn_plan(offsets, timestamps, capacity,
                               block=self.block,
                               max_row_len=self.max_row_len)

    def __call__(self, q, k, v, offsets, timestamps, rab_params, rab, *,
                 time_mode: str = "bucket",
                 plan: Optional[JaggedAttnPlan] = None) -> torch.Tensor:
        return jagged_attention(q, k, v, offsets, timestamps, rab_params,
                                rab, time_mode=time_mode,
                                block=self.block, plan=plan,
                                schedule=self.schedule,
                                max_row_len=self.max_row_len)


def make_attn_fn(*, block: int = 128, schedule: str = "worklist",
                 max_row_len: Optional[int] = None) -> PlannedAttention:
    """attn_fn factory for models.hstu.hstu_block(attn_fn=...):
    ``schedule="dense"`` selects K8."""
    return PlannedAttention(block=block, schedule=schedule,
                            max_row_len=max_row_len)
