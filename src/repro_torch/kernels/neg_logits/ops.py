"""The negative-sampling logit kernels (the port of
``repro.kernels.neg_logits.ops``): the fused ID-driven recall path
:func:`fused_recall_lse` (K3/K4) and the logits over materialised negative
rows :func:`neg_logits` (K9).

:func:`neg_logits` is o·n/τ over a (T, R, D) negative tensor, the §4.3.1
baseline of Table 7 and the per-segment logits of the segmented path: a
``torch.autograd.Function`` whose forward is K9-fwd and backward K9-bwd
(``csrc/neg_logits.cu``) for CUDA tensors, their plain versions
(``ref.py``) for CPU tensors. Its backward can hand the negative rows'
grad dn to a callback, which is how the training path takes their table
gradient as sparse pairs.

:func:`fused_recall_lse` returns each token's logsumexp over
[pos | R negatives | (k−1)·R shared] as a ``torch.autograd.Function``:
forward K3, backward K4 (``csrc/neg_fused.cu``) for CUDA tensors, their
plain versions (``ref.py``) for CPU tensors. Neither the (T, R, D) rows
nor the (T, R·k) logits are built on the card.

The table gradient leaves K4 as per-(token, slot) weights w. On the
training path it goes to a caller's :class:`TableGradSink` as sparse
pairs, never as a (V, D) array: with ``scatter_impl="fused"`` (the
default) in factored form — ids, w, the padded o and 1/τ — which K5
reduces without building the rows; with ``"two_pass"`` (the oracle) as the
rows w·o/τ. When the table itself requires grad (test sizes) it is
scattered into a dense (V, D) grad by the same two impls.

Sharing permutations: the reference draws them with ``jax.random`` from
the batch's key; the port takes them as ``perms`` or draws its own from a
``torch.Generator`` (a declared divergence: same distribution, other
numbers). ``expansion=1`` draws nothing.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.jagged_lookup.ops import (check_scatter_impl,
                                                   scatter_add_weighted_rows)
from repro_torch.kernels.neg_logits import ref as R_
from repro_torch.kernels.neg_logits.ref import NEG_POOL

#: Launches of each kernel in this module, counted where the wrapper
#: launches it and nowhere else.
KERNEL_LAUNCHES: Dict[str, int] = {"neg_fwd": 0, "neg_bwd": 0,
                                   "neg_logits_fwd": 0, "neg_logits_bwd": 0}

KERNEL_WIDTHS = (256, 512, 768, 1024)
_O_CODE = {torch.float32: 0, torch.bfloat16: 1}
_T_CODE = {torch.float32: 0, torch.float16: 1}
_ROUND_CODE = {None: 0, torch.float16: 1, torch.bfloat16: 2}
_FWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


_N_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NL_FWD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_float] + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
#: K9-fwd's grid: enough CTAs to fill the card (8 per SM, 132 SMs, ~1024)
#: with each still taking at least NL_FWD_MIN_ROWS rows (a group of 4 for
#: each of its 8 warps)
NL_FWD_CTAS = 1024
NL_FWD_MIN_ROWS = 32
_NL_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                    + [ctypes.c_float] + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
#: K9-bwd's row groups per token (a CTA of 128 threads each): raised while
#: T·split is below NL_BWD_CTAS (4 per SM of 132) and each group keeps at
#: least NL_BWD_MIN_ROWS rows, up to NL_BWD_MAX_SPLIT (512 threads)
NL_BWD_CTAS = 512
NL_BWD_MIN_ROWS = 16
NL_BWD_MAX_SPLIT = 4
#: K4's tokens per CTA (a warp each; ``csrc/neg_fused.cu`` BWD_WARPS), its
#: rows in each warp's ring (STAGES)
NEG_BWD_TOKENS = 8
NEG_BWD_STAGES = 4


def _lib():
    lib = _build.load("neg_fused")
    if lib.neg_fused_fwd.argtypes is None:
        lib.neg_fused_fwd.argtypes = _FWD_ARGTYPES
        lib.neg_fused_fwd.restype = ctypes.c_int
        lib.neg_fused_bwd.argtypes = _BWD_ARGTYPES
        lib.neg_fused_bwd.restype = ctypes.c_int
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"neg_fused kernel: {msg}")


class TableGradSink:
    """Receives the negative path's table gradient as sparse pairs. After
    backward, ``ids`` (T·R,) int32 are the negative slots' ids and
    ``rows`` an fp32 (n_ready + extra_rows, D) buffer whose last
    ``extra_rows`` rows are left for the caller's own (id, row)
    contributions, so a step's whole table gradient sits in one stream of
    slots and is never concatenated. With ``scatter_impl="two_pass"`` the
    first n_ready = T·R rows are w·o/τ and ``neg`` is None; with
    ``"fused"`` no negative row is built (n_ready = 0) and ``neg`` holds
    them in factored form, ``(w (Tp, R) fp32, o (Tp, D), 1/τ)``: slot j's
    row is ``w.flat[j] · (o[j // R] · 1/τ)``, what K5 takes. The baseline
    and segmented paths (K9) hand over their rows through
    :meth:`ready_rows`."""

    def __init__(self, extra_rows: int = 0):
        self.extra_rows = extra_rows
        self.ids: Optional[torch.Tensor] = None
        self.rows: Optional[torch.Tensor] = None
        self.neg: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None

    def ready_rows(self, ids: torch.Tensor, D: int,
                   device: torch.device) -> torch.Tensor:
        """The rows form for n = ``ids.numel()`` negative slots whose rows
        the caller builds itself (the baseline and segmented paths write
        their dn there): sets ``ids`` and an fp32 ``rows`` buffer of n +
        ``extra_rows`` rows, and returns its first n rows to fill."""
        n = ids.numel()
        self.ids = ids.reshape(-1).to(torch.int32)
        self.rows = torch.empty((n + self.extra_rows, D), dtype=torch.float32,
                                device=device)
        self.neg = None
        return self.rows[:n]


def make_share_perms(n_seg: int, segment: int, expansion: int, *,
                     perms: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """(n_seg, max(expansion−1, 1), segment) int32 per-segment shuffle for
    §4.3.3 sharing: entry [s, e, t] is the segment-local token whose R
    logits consumer t borrows for slot e, a random cyclic shift (never the
    identity). ``perms`` given → checked and returned (the tests inject the
    reference's); otherwise drawn from ``generator``. expansion ≤ 1 → a
    zero dummy of the same rank, nothing drawn."""
    shape = (n_seg, max(expansion - 1, 1), segment)
    if expansion <= 1:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    if perms is not None:
        perms = torch.as_tensor(perms, device=device).to(torch.int32)
        if tuple(perms.shape) != shape:
            raise ValueError(f"perms {tuple(perms.shape)}, expected {shape}")
        return perms.contiguous()
    gen_dev = generator.device if generator is not None else device
    shifts = torch.randint(1, segment, (n_seg, expansion - 1),
                           generator=generator, device=gen_dev)
    base = torch.arange(segment, device=gen_dev)
    return ((base[None, None, :] + shifts[:, :, None]) % segment).to(
        device=device, dtype=torch.int32)


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def prepare_fused_inputs(out_emb, pos_logit, vocab: int, neg_ids, *,
                         segment: int, expansion: int,
                         perms: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         valid: Optional[torch.Tensor] = None):
    """Pad / clip / mask / shuffle prep shared by the kernels and the plain
    versions. → (o_p, pos_p, ids_p (Tp·R,) int32, valid_p, perms, n_seg),
    rows zero-padded to a segment multiple (padded tokens invalid, their
    ids row 0)."""
    T, R = neg_ids.shape
    if not 1 <= expansion <= segment:
        raise ValueError(f"expansion {expansion} not in [1, {segment}]")
    pad = (-T) % segment
    n_seg = (T + pad) // segment
    dev = out_emb.device
    v = (torch.ones((T,), dtype=torch.float32, device=dev) if valid is None
         else valid.to(torch.float32))
    valid_p = _pad_rows(v, pad)
    pos_p = _pad_rows(pos_logit.to(torch.float32), pad)
    ids_p = _pad_rows(neg_ids.clamp(0, vocab - 1).to(torch.int32), pad)
    o_p = _pad_rows(out_emb, pad)
    perms = make_share_perms(n_seg, segment, expansion, perms=perms,
                             generator=generator, device=dev)
    return o_p, pos_p, ids_p.reshape(-1).contiguous(), valid_p, perms, n_seg


def _check(o, pos, src, ids, valid, perms, segment, R, fetch_dtype,
           backward=False):
    dev = o.device
    _require(dev.type == "cuda", f"tensors on {dev}, not on the card")
    _require(o.dtype in _O_CODE, f"o dtype {o.dtype}; takes float32 or "
             f"bfloat16")
    _require(src.dtype in _T_CODE, f"table dtype {src.dtype}")
    _require(fetch_dtype is None or (src.dtype == torch.float32
                                     and fetch_dtype in _ROUND_CODE),
             f"fetch rounding {fetch_dtype} of a {src.dtype} table")
    D = o.shape[1]
    _require(D in KERNEL_WIDTHS and src.shape[1] == D,
             f"row width {D} not in {KERNEL_WIDTHS}")
    Tp = o.shape[0]
    _require(Tp % segment == 0 and ids.shape == (Tp * R,)
             and pos.shape == (Tp,) and valid.shape == (Tp,),
             "shapes of o, pos, ids, valid")
    for name, t, dt in (("pos", pos, torch.float32),
                        ("ids", ids, torch.int32),
                        ("valid", valid, torch.float32),
                        ("perms", perms, torch.int32)):
        _require(t.dtype == dt and t.device == dev and t.is_contiguous(),
                 f"{name} must be contiguous {dt} on {dev}")
    for name, t in (("o", o), ("table", src)):
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name} must be contiguous and 16-byte aligned")
    nsh = perms.shape[1]                 # at least expansion - 1 slots
    if backward:
        _require(segment % NEG_BWD_TOKENS == 0, f"segment {segment} is not "
                 f"a multiple of {NEG_BWD_TOKENS} tokens (a CTA of K4)")
        smem = (NEG_BWD_TOKENS * (NEG_BWD_STAGES * D * src.element_size()
                                  + R * 4 + nsh * -(-segment // 32) * 4
                                  + (nsh + 1) * 4 + 4)
                + (2 + nsh) * segment * 4)
    else:
        smem = (segment * R + nsh * segment) * 4
    _require(smem <= 227 * 1024, f"segment {segment} x R {R} needs {smem} "
             f"bytes of shared memory")


def neg_fwd(o, pos, src, ids, valid, perms, *, segment: int, R: int,
            expansion: int, inv_tau: float,
            fetch_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """K3 for card tensors, its plain version for CPU tensors → lse."""
    kw = dict(segment=segment, R=R, expansion=expansion, inv_tau=inv_tau,
              fetch_dtype=fetch_dtype)
    if o.device.type == "cpu":
        return R_.neg_fwd_plain(o, pos, src, ids, valid, perms, **kw)
    _check(o, pos, src, ids, valid, perms, segment, R, fetch_dtype)
    lse = torch.empty_like(pos)
    dev = o.device
    with torch.cuda.device(dev):
        rc = _lib().neg_fused_fwd(
            o.data_ptr(), pos.data_ptr(), src.data_ptr(), ids.data_ptr(),
            valid.data_ptr(), perms.data_ptr(), lse.data_ptr(),
            o.shape[0] // segment, segment, R, o.shape[1], perms.shape[1],
            expansion, inv_tau, _ROUND_CODE[fetch_dtype], _O_CODE[o.dtype],
            _T_CODE[src.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"neg_fused_fwd launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["neg_fwd"] += 1
    return lse


def neg_bwd(o, pos, src, ids, valid, perms, lse, g, *, segment: int, R: int,
            expansion: int, inv_tau: float,
            fetch_dtype: Optional[torch.dtype]):
    """K4 for card tensors, its plain version for CPU tensors →
    (w (Tp, R), dout (Tp, D), dpos (Tp,)), fp32."""
    kw = dict(segment=segment, R=R, expansion=expansion, inv_tau=inv_tau,
              fetch_dtype=fetch_dtype)
    if o.device.type == "cpu":
        return R_.neg_bwd_plain(o, pos, src, ids, valid, perms, lse, g, **kw)
    _check(o, pos, src, ids, valid, perms, segment, R, fetch_dtype,
           backward=True)
    _require(lse.shape == pos.shape and g.shape == pos.shape
             and lse.dtype == torch.float32 and g.dtype == torch.float32
             and lse.is_contiguous() and g.is_contiguous(),
             "lse and g must be contiguous (Tp,) float32")
    Tp, D = o.shape
    w = torch.empty((Tp, R), dtype=torch.float32, device=o.device)
    dout = torch.empty((Tp, D), dtype=torch.float32, device=o.device)
    dpos = torch.empty_like(pos)
    dev = o.device
    with torch.cuda.device(dev):
        rc = _lib().neg_fused_bwd(
            o.data_ptr(), pos.data_ptr(), src.data_ptr(), ids.data_ptr(),
            valid.data_ptr(), perms.data_ptr(), lse.data_ptr(), g.data_ptr(),
            w.data_ptr(), dout.data_ptr(), dpos.data_ptr(), Tp // segment,
            segment, R, D, perms.shape[1], expansion, inv_tau,
            _ROUND_CODE[fetch_dtype], _O_CODE[o.dtype], _T_CODE[src.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"neg_fused_bwd launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["neg_bwd"] += 1
    return w, dout, dpos


class _FusedLse(torch.autograd.Function):
    """lse of the padded tokens; differentiable in o, pos and the table.
    Non-tensor settings ride in ``kw``; ``sink`` is the caller's
    ``table_grad_pairs`` list (or None)."""

    @staticmethod
    def forward(ctx, o, pos, table, src, ids, valid, perms, T, kw, sink,
                scatter_impl):
        lse = neg_fwd(o, pos, src, ids, valid, perms, **kw)
        ctx.save_for_backward(o, pos, src, ids, valid, perms, lse)
        ctx.vocab = table.shape[0]
        ctx.table_dtype = table.dtype
        ctx.T, ctx.kw, ctx.sink = T, kw, sink
        ctx.scatter_impl = scatter_impl
        return lse

    @staticmethod
    def backward(ctx, g):
        o, pos, src, ids, valid, perms, lse = ctx.saved_tensors
        kw = ctx.kw
        w, dout, dpos = neg_bwd(o, pos, src, ids, valid, perms, lse,
                                g.float().contiguous(), **kw)
        dtable = None
        sink = ctx.sink
        if sink is not None:
            T, R = ctx.T, kw["R"]
            D = o.shape[1]
            n_ready = T * R if ctx.scatter_impl == "two_pass" else 0
            sink.rows = torch.empty((n_ready + sink.extra_rows, D),
                                    dtype=torch.float32, device=o.device)
            if n_ready:
                # the two-pass rows w·(o·τ⁻¹), the reference's op order
                torch.mul(w[:T, :, None],
                          (o[:T].float() * kw["inv_tau"])[:, None],
                          out=sink.rows[:n_ready].view(T, R, D))
            else:
                sink.neg = (w, o, kw["inv_tau"])
            sink.ids = ids[:T * R]
        elif ctx.needs_input_grad[2]:
            dtable = scatter_add_weighted_rows(
                w, o, ids, ctx.vocab, scale=kw["inv_tau"],
                impl=ctx.scatter_impl).to(ctx.table_dtype)
        return (dout.to(o.dtype), dpos, dtable, None, None, None, None, None,
                None, None, None)


def fused_recall_lse(out_emb: torch.Tensor, pos_logit: torch.Tensor,
                     table: torch.Tensor, neg_ids: torch.Tensor, *,
                     segment: int = 128, tau: float = 1.0,
                     expansion: int = 1,
                     perms: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     valid: Optional[torch.Tensor] = None,
                     fetch_dtype: Optional[torch.dtype] = None,
                     gather_table: Optional[torch.Tensor] = None,
                     scatter_impl: str = "fused",
                     table_grad_pairs: Optional[TableGradSink] = None
                     ) -> torch.Tensor:
    """Per-token logsumexp over [pos | R negatives | (k−1)·R shared]
    (Eq. 2): out_emb (T, D), pos_logit (T,), table (V, D) fp32 master,
    neg_ids (T, R) → (T,) fp32.

    ``gather_table`` is the half-precision shadow the rows are read from
    (the gradient still flows to ``table``, straight through); without it
    the rows come from ``table``, rounded to ``fetch_dtype``.
    ``table_grad_pairs``, a :class:`TableGradSink`, receives the table
    gradient as sparse pairs in backward instead of a dense grad, in the
    form ``scatter_impl`` names: ``"fused"`` (the default: factored, for
    K5) or ``"two_pass"`` (the rows)."""
    check_scatter_impl(scatter_impl)
    T, R = neg_ids.shape
    V = table.shape[0]
    o_p, pos_p, ids_p, valid_p, perms, n_seg = prepare_fused_inputs(
        out_emb, pos_logit, V, neg_ids, segment=segment,
        expansion=expansion, perms=perms, generator=generator, valid=valid)
    src = table if gather_table is None else gather_table
    kw = dict(segment=segment, R=R, expansion=expansion, inv_tau=1.0 / tau,
              fetch_dtype=fetch_dtype if gather_table is None else None)
    lse = _FusedLse.apply(o_p.contiguous(), pos_p.contiguous(), table, src,
                          ids_p, valid_p.contiguous(), perms, T, kw,
                          table_grad_pairs, scatter_impl)
    return lse[:T]


# --------------------------------------------------------------------------
# K9: logits over materialised negative rows
# --------------------------------------------------------------------------

def _nl_lib():
    lib = _build.load("neg_logits")
    if lib.neg_logits_fwd.argtypes is None:
        lib.neg_logits_fwd.argtypes = _NL_FWD_ARGTYPES
        lib.neg_logits_fwd.restype = ctypes.c_int
        lib.neg_logits_bwd.argtypes = _NL_BWD_ARGTYPES
        lib.neg_logits_bwd.restype = ctypes.c_int
    return lib


def _check_nl(o: torch.Tensor, n: torch.Tensor) -> None:
    req = lambda c, m: _require(c, f"(neg_logits) {m}")    # noqa: E731
    dev = o.device
    req(dev.type == "cuda" and n.device == dev,
        f"tensors on {dev} and {n.device}, not on one card")
    req(o.dtype in _O_CODE and n.dtype in _N_CODE,
        f"o {o.dtype}, n {n.dtype}; takes o float32/bfloat16 and n "
        f"float32/bfloat16/float16")
    req(o.dim() == 2 and n.dim() == 3 and n.shape[0] == o.shape[0]
        and n.shape[2] == o.shape[1] and o.shape[0] > 0 and n.shape[1] > 0,
        f"o {tuple(o.shape)}, n {tuple(n.shape)}; takes (T, D), (T, R, D)")
    req(o.shape[1] % (16 // n.element_size()) == 0,
        f"row width {o.shape[1]} is not a whole number of 16-byte vectors "
        f"of {n.dtype}")
    req(o.is_contiguous() and n.is_contiguous() and o.data_ptr() % 16 == 0
        and n.data_ptr() % 16 == 0,
        "o and n must be contiguous and 16-byte aligned")


def fwd_row_split(T: int, R: int) -> int:
    """CTAs per token of K9-fwd: doubled from 1 while T·split is below
    ``NL_FWD_CTAS`` and each CTA keeps at least ``NL_FWD_MIN_ROWS`` of the
    token's R rows. 1 at T = 8192; 4 for a 128-token segment of R = 128.
    The split changes which CTA sums a logit, never how (its bits)."""
    split = 1
    while T * split < NL_FWD_CTAS and R >= 2 * split * NL_FWD_MIN_ROWS:
        split *= 2
    return split


def bwd_row_split(T: int, R: int) -> int:
    """Row groups per token of K9-bwd (each 128 threads of the token's
    CTA): doubled from 1 while T·split is below ``NL_BWD_CTAS``, each group
    keeps at least ``NL_BWD_MIN_ROWS`` of the R rows and split stays within
    ``NL_BWD_MAX_SPLIT``. 1 at T = 8192 (each do summed in r order, as
    before); 4 for a 128-token segment of R = 128, whose do partials are
    then added in group order (another fixed order, the same bits run to
    run); dn keeps its bits whatever the split."""
    split = 1
    while (T * split < NL_BWD_CTAS and split < NL_BWD_MAX_SPLIT
           and R >= 2 * split * NL_BWD_MIN_ROWS):
        split *= 2
    return split


def neg_logits_fwd(o: torch.Tensor, n: torch.Tensor, *,
                   inv_tau: float) -> torch.Tensor:
    """K9-fwd for card tensors, its plain version for CPU tensors: o (T, D)
    fp32/bf16, n (T, R, D) fp32/bf16/fp16 → (T, R) fp32 o·n · 1/τ."""
    if o.device.type == "cpu":
        return R_.neg_logits_fwd_plain(o, n, inv_tau=inv_tau)
    _check_nl(o, n)
    T, R, D = n.shape
    out = torch.empty((T, R), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        rc = _nl_lib().neg_logits_fwd(
            o.data_ptr(), n.data_ptr(), out.data_ptr(), T, R, D,
            fwd_row_split(T, R), inv_tau, _O_CODE[o.dtype], _N_CODE[n.dtype],
            torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"neg_logits_fwd launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["neg_logits_fwd"] += 1
    return out


def neg_logits_bwd(o: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *,
                   inv_tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9-bwd for card tensors, its plain version for CPU tensors: with gs
    = g · 1/τ, (do = Σ_r gs·n (T, D) fp32, dn = gs·o (T, R, D) in n's
    dtype)."""
    if o.device.type == "cpu":
        return R_.neg_logits_bwd_plain(o, n, g, inv_tau=inv_tau)
    _check_nl(o, n)
    T, R, D = n.shape
    _require(g.shape == (T, R) and g.dtype == torch.float32
             and g.device == o.device and g.is_contiguous(),
             f"(neg_logits) g {tuple(g.shape)} {g.dtype}; takes contiguous "
             f"({T}, {R}) float32")
    dout = torch.empty((T, D), dtype=torch.float32, device=o.device)
    dn = torch.empty_like(n)
    with torch.cuda.device(o.device):
        rc = _nl_lib().neg_logits_bwd(
            o.data_ptr(), n.data_ptr(), g.data_ptr(), dout.data_ptr(),
            dn.data_ptr(), T, R, D, bwd_row_split(T, R), inv_tau,
            _O_CODE[o.dtype], _N_CODE[n.dtype],
            torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"neg_logits_bwd launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["neg_logits_bwd"] += 1
    return dout, dn


class _NegLogits(torch.autograd.Function):
    """o·n/τ: forward K9-fwd, backward K9-bwd (or their plain versions).
    ``on_neg_grad(dn)``, when given, receives dn in backward, whether or
    not n itself requires grad."""

    @staticmethod
    def forward(ctx, o, n, inv_tau, on_neg_grad):
        ctx.save_for_backward(o, n)
        ctx.inv_tau, ctx.on_neg_grad = inv_tau, on_neg_grad
        return neg_logits_fwd(o, n, inv_tau=inv_tau)

    @staticmethod
    def backward(ctx, g):
        o, n = ctx.saved_tensors
        do, dn = neg_logits_bwd(o, n, g.float().contiguous(),
                                inv_tau=ctx.inv_tau)
        if ctx.on_neg_grad is not None:
            ctx.on_neg_grad(dn)
        return (do.to(o.dtype), dn if ctx.needs_input_grad[1] else None,
                None, None)


def neg_logits(out_emb: torch.Tensor, neg_emb: torch.Tensor, *,
               segment: Optional[int] = 128, tau: float = 1.0,
               on_neg_grad: Optional[Callable[[torch.Tensor], None]] = None
               ) -> torch.Tensor:
    """(T, D) × (T, R, D) → (T, R) fp32 logits o·n/τ, differentiable in
    both: forward K9-fwd, backward K9-bwd; ``dn`` comes back in
    ``neg_emb``'s dtype (fp16/bf16 on the §4.3.2 quantized paths), ``do``
    in ``out_emb``'s. T is zero-padded to a ``segment`` multiple, as the
    reference pads it for its segment grid (no effect on the values: the
    kernels are per token; None pads nothing). ``on_neg_grad(dn)``, if
    given, receives the (T, R, D) grad of ``neg_emb`` in backward: the
    training path's table-grad rows."""
    T = out_emb.shape[0]
    pad = (-T) % segment if segment else 0
    o = _pad_rows(out_emb, pad).contiguous()
    n = _pad_rows(neg_emb, pad).contiguous()
    hook = on_neg_grad
    if hook is not None and pad:
        hook = lambda dn: on_neg_grad(dn[:T])          # noqa: E731
    out = _NegLogits.apply(o, n, 1.0 / tau, hook)
    return out[:T] if pad else out


__all__ = ["KERNEL_LAUNCHES", "NEG_POOL", "TableGradSink", "bwd_row_split",
           "fused_recall_lse", "fwd_row_split", "make_share_perms",
           "neg_bwd", "neg_fwd", "neg_logits",
           "neg_logits_bwd", "neg_logits_fwd", "prepare_fused_inputs"]
