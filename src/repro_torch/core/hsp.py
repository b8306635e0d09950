"""Hierarchical Sparse Parallelism (paper §4.2.1), the port of
``repro.core.hsp`` over ``torch.distributed`` (a :class:`~repro_torch.
launch.mesh.Mesh`).

Topology: the embedding table is split into contiguous row ranges over the
``group_axes`` (the ``model`` group of I ranks: rank index j owns rows
[j·V/I, (j+1)·V/I), the reference's ``_shard_lo``) and replicated over the
``dp_axes`` (``data``). Each rank holds only its shard.

* **Lookup** — the paper's two-phase all-to-all: each rank sends the
  unique ids it reads (ascending, so each owner's are one run) to their
  owners, the split sizes first; each owner gathers its rows with K7
  (``gather_rows``, on shard-relative ids) and sends them back by a second
  all-to-all. A row has exactly one owner, so the result equals
  ``table[ids].to(compute_dtype)`` bit for bit, as the reference's masked
  ``psum_scatter`` does. Ids < 0 give zero rows; ids ≥ V read row V − 1
  (the clip of ``jnp.take`` and of the fused negative path), clipped
  before routing. The reference all-gathers the ids over the group and
  reduce-scatters partial rows; an all-to-all moves only what each owner
  must answer (a declared divergence).
* **Negatives** (:meth:`HSPLookup.fetch_rows`) — the same exchange in the
  table's own dtype (the fp16 shadow): a compact (U, d) buffer of the
  unique rows and each id's position in it, which K3/K4 read in place of
  the shadow.
* **Sparse gradient exchange** — local unique pairs (K6's sorted run-sum),
  wire compression (fp32, bf16, or int8 with a per-row amax/127 scale
  shipped beside it, the reference's :168-177), an all-to-all of the (id,
  row) pairs to their owners in the group, the owner's run-sum over what
  it received, then the inter-group step over ``data`` in sparse form
  only: an all-gather of each owner's unique pairs (compressed again) and
  one more run-sum in replica order. Every replica of a shard thus lands
  the identical aggregate G_t, so the AdaGrad states stay bitwise equal
  across groups (Eq. 1). The reference's dense ``psum`` of the (V/I, d)
  shard (8.6 GB a step at 2²¹ rows) is not ported (a declared divergence).
* **Logit sharing across ranks** (:meth:`HSPLookup.share_tokens`, §4.3.3
  at ``expansion`` > 1): the pool is the global batch's, ordered rank by
  rank and cut into segments (``kernels/neg_logits/ops.py``
  ``share_layout``); K3 builds a segment's logits in one CTA, so each
  segment is computed on the rank that holds its first token. The tokens
  of a segment that straddles two ranks' packs travel to that owner (o
  row, positive logit, valid flag, R negative ids), the owner fetches
  their negative rows with its own and counts them in its part of the
  loss; in backward their dout and dpos travel home. Nothing moves when
  the pack is a segment multiple.
* **Baseline** — global sharding is the same object with
  ``group_axes=("data", "model")`` and no ``dp_axes``: the exchange then
  spans the whole world (Table 4's other arm).

The training step's dense half also runs here: the loss's valid-token
count and the loss summed over all ranks, the dense grads summed over all
ranks in rank order (every rank gets the same bits), and checks that the
dense replicas and the ``data`` replicas of each shard stay equal.

Every exchange counts, by kind, the bytes and the peers this rank sends to
(``Mesh.stats``): ``lookup_ids``, ``lookup_rows``, ``neg_ids``,
``neg_rows``, ``share_tokens`` and ``share_grads`` (the straddling
tokens out and their grads back), ``grad_group`` (pairs within the
group), ``grad_replicas`` (pairs across groups), ``dense``, ``loss``,
``check``.

Collectives are issued only from the training step's device stages, which
the engine runs on its main thread in the schedule's fixed order, so every
rank issues them in the same sequence.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.jagged_lookup.ops import (gather_rows, run_totals,
                                                   scatter_add_rows as
                                                   _dense_scatter,
                                                   sort_pairs, unique_pairs)
from repro_torch.kernels.neg_logits.ops import ShareLayout

GRAD_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


# --------------------------------------------------------------------------
# ownership: the one rule for which rows and carry pairs a shard holds
# --------------------------------------------------------------------------

def shard_bounds(vocab: int, index: int, size: int) -> Tuple[int, int]:
    """Rows [lo, hi) of shard ``index`` of ``size`` over a ``vocab``-row
    table: contiguous equal ranges (the reference's ``_shard_lo``). The
    engine's draw, the restore, ``convert``'s split and ``reshard`` all
    take a shard's rows from here."""
    if vocab % size:
        raise ValueError(f"vocab {vocab} does not split into {size} equal "
                         f"row ranges")
    vs = vocab // size
    return index * vs, (index + 1) * vs


def carry_span(ids, lo: int, hi: int) -> Tuple[int, int]:
    """Positions [a, b) of the pairs of rows [lo, hi) in a τ=1 carry whose
    ids ascend (a tensor or a numpy array)."""
    if isinstance(ids, torch.Tensor):
        a, b = torch.searchsorted(
            ids.to(torch.int64),
            torch.tensor([lo, hi], dtype=torch.int64,
                         device=ids.device)).tolist()
    else:
        a, b = np.searchsorted(np.asarray(ids, np.int64), [lo, hi])
    return int(a), int(b)

#: Rows of a shard checked at a time (bounds the checks' temporaries).
_CHECK_ROWS = 1 << 16


# --------------------------------------------------------------------------
# fixed-capacity unique + accumulate (the pipeline's "unique" stage)
# --------------------------------------------------------------------------

def unique_accumulate(ids: torch.Tensor, rows: torch.Tensor,
                      num_out: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deduplicate ids, summing their rows (a device sort, then K6's sorted
    run-sum), in the reference's layout: ids (n,) (negative = invalid),
    rows (n, d) → (uids (num_out,) int32 ascending with −1 fill, urows
    (num_out, d) fp32, zero rows in the fill); ids beyond ``num_out``
    unique ones (the largest) are dropped. ``num_out`` defaults to n."""
    ids = ids.reshape(-1)
    n, d = rows.shape
    num_out = n if num_out is None else int(num_out)
    u, tot = unique_pairs(rows.float(), ids)
    k = min(u.numel(), num_out)
    uids = torch.full((num_out,), -1, dtype=torch.int32, device=rows.device)
    urows = torch.zeros((num_out, d), dtype=torch.float32,
                        device=rows.device)
    uids[:k] = u[:k]
    urows[:k] = tot[:k]
    return uids, urows


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``table`` plus the rows summed per id (a new array), ids < 0 or
    ≥ len(table) dropped: the reference's ``table.at[ids].add``."""
    add = _dense_scatter(rows.float(), ids.reshape(-1), table.shape[0])
    return (table.float() + add).to(table.dtype)


def dense_lookup(table: torch.Tensor, ids: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain differentiable gather (the dense-grad baseline)."""
    return table[ids.long()].to(compute_dtype)


def adagrad_update(table: torch.Tensor, accum: torch.Tensor,
                   grad: torch.Tensor, lr: float, eps: float = 1e-10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S_t = S_{t−1} + G_t²;  W_{t+1} = W_t − η·G_t/√(S_t + ε) (Eq. 1), on
    dense arrays, returning new ones. Because every group receives the
    identical aggregate G_t from the sparse exchange, the per-group states
    stay bitwise equal."""
    g = grad.float()
    accum = accum + g * g
    table = table - lr * g * torch.rsqrt(accum + eps)
    return table, accum


# --------------------------------------------------------------------------
# the HSP exchange
# --------------------------------------------------------------------------

def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(n, ...) → (n, bytes per row) uint8 view of a contiguous tensor."""
    width = int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()
    if t.numel() == 0:
        return torch.empty((t.shape[0], width), dtype=torch.uint8,
                           device=t.device)
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], width)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, width: int
                ) -> torch.Tensor:
    """(n, k) uint8 → (n, width) ``dtype``."""
    n = b.shape[0]
    if n == 0:
        return torch.empty((0, width), dtype=dtype, device=b.device)
    return b.contiguous().view(dtype).reshape(n, width)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns as int64 (for exact checksums)."""
    view = {8: torch.int64, 4: torch.int32, 2: torch.int16,
            1: torch.uint8}[t.element_size()]
    return t.contiguous().view(view).to(torch.int64)


def bit_checksum(t: torch.Tensor, chunk: int = 1 << 26) -> torch.Tensor:
    """(2,) int64: the sum of a tensor's bit patterns and their sum
    weighted by position (mod 65521, plus one), both mod 2^64: equal for
    equal bits. ``chunk`` elements at a time, so a table shard needs no
    int64 copy of itself."""
    flat = t.detach().contiguous().reshape(-1)
    w = torch.arange(min(chunk, max(flat.numel(), 1)), device=t.device,
                     dtype=torch.int64) % 65521 + 1
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for lo in range(0, flat.numel(), chunk):
        b = _bits(flat[lo:lo + chunk])
        out[0] += b.sum()
        out[1] += (b * w[:b.numel()]).sum()
    return out


class ReplicaDivergence(RuntimeError):
    """Two replicas that must hold the same bits do not."""


class HSPLookup:
    """The HSP lookup and exchange of one rank (build it with
    :func:`make_hsp_lookup`). Calling it, ``lookup(shard, ids)``, is the
    standalone differentiable lookup: forward the exchange, backward the
    sparse gradient exchange landed as a dense (V/I, d) shard grad (test
    sizes, as the port's ``jagged_lookup``). The training step uses its
    pieces: :meth:`gather`, :meth:`fetch_rows`, :meth:`exchange_grads`,
    :meth:`valid_total`, :meth:`reduce_loss`, :meth:`reduce_dense` and
    :meth:`check_replicas`."""

    def __init__(self, mesh, *, group_axes: Tuple[str, ...] = ("model",),
                 dp_axes: Tuple[str, ...] = ("data",),
                 compute_dtype=torch.bfloat16,
                 unique_capacity: Optional[int] = None,
                 grad_wire_dtype=torch.float32):
        if grad_wire_dtype not in GRAD_WIRE_DTYPES:
            raise ValueError(f"grad_wire_dtype {grad_wire_dtype} not in "
                             f"{GRAD_WIRE_DTYPES}")
        both = set(group_axes) & set(dp_axes)
        if both or set(group_axes) | set(dp_axes) != set(mesh.axes):
            raise ValueError(f"group axes {group_axes} and replica axes "
                             f"{dp_axes} must split the mesh's {mesh.axes}")
        self.mesh = mesh
        self.group_axes = tuple(group_axes)
        self.dp_axes = tuple(dp_axes)
        self.compute_dtype = compute_dtype
        self.unique_capacity = unique_capacity
        self.grad_wire_dtype = grad_wire_dtype
        g = mesh.group(self.group_axes)
        self.group_size = g.size
        self.shard_index = g.index
        self.replicas = mesh.size(self.dp_axes)
        self.checks = {"dense": 0, "table": 0}

    # -- geometry ----------------------------------------------------------
    @property
    def world(self) -> int:
        return self.mesh.world

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def shard_range(self, vocab: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a ``vocab``-row table."""
        return shard_bounds(vocab, self.shard_index, self.group_size)

    def vocab_of(self, shard: torch.Tensor) -> int:
        return shard.shape[0] * self.group_size

    # -- the two-phase all-to-all ------------------------------------------
    def _owner_counts(self, uids: torch.Tensor, vs: int):
        """Per-owner counts of ascending ids ≥ 0 (owners hold contiguous
        ranges, so each owner's ids are one run)."""
        bounds = torch.arange(1, self.group_size + 1, device=uids.device,
                              dtype=torch.int64) * vs
        ends = torch.searchsorted(uids.to(torch.int64), bounds)
        ends = ends.tolist()
        return [e - s for s, e in zip([0] + ends[:-1], ends)]

    def _request(self, shard: torch.Tensor, uids: torch.Tensor,
                 dtype: torch.dtype, kind: str) -> torch.Tensor:
        """The rows of ascending unique global ids ``uids`` (in [0, V)) in
        ``dtype``, from their owners: ids out (shard-relative, int32), K7
        at the owner, rows back."""
        vs = shard.shape[0]
        counts = self._owner_counts(uids, vs)
        owner = torch.repeat_interleave(
            torch.arange(self.group_size, device=uids.device),
            torch.tensor(counts, device=uids.device))
        rel = (uids.to(torch.int64) - owner * vs).to(torch.int32)
        got, rcounts = self.mesh.all_to_all_v(
            _as_bytes(rel[:, None]), counts, self.group_axes, f"{kind}_ids")
        asked = _from_bytes(got, torch.int32, 1).reshape(-1)
        rows = gather_rows(shard, asked, dtype)
        back, _ = self.mesh.all_to_all_v(_as_bytes(rows), rcounts,
                                         self.group_axes, f"{kind}_rows")
        return _from_bytes(back, dtype, shard.shape[1])

    def _unique_reads(self, ids: torch.Tensor, vocab: int):
        """(unique clipped ids ≥ 0 ascending, each read's index into them,
        the mask of reads with id ≥ 0)."""
        flat = ids.reshape(-1).to(torch.int64)
        keep = flat >= 0
        clipped = torch.where(keep, flat.clamp(max=vocab - 1),
                              torch.zeros_like(flat))
        uids, inv = torch.unique(clipped[keep], sorted=True,
                                 return_inverse=True)
        index = torch.zeros_like(flat)
        index[keep] = inv
        return uids, index, keep

    def gather(self, shard: torch.Tensor, ids: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The lookup's forward: ids (...) → (..., d) in ``dtype`` (default
        ``compute_dtype``), bit for bit ``table[clip(ids)].to(dtype)`` with
        zero rows for ids < 0. Each distinct id is sent once."""
        dtype = dtype or self.compute_dtype
        uids, index, keep = self._unique_reads(ids, self.vocab_of(shard))
        rows = self._request(shard, uids, dtype, "lookup")
        out = rows[index]
        out = torch.where(keep[:, None], out, torch.zeros_like(out))
        return out.reshape(*ids.shape, shard.shape[1])

    def fetch_rows(self, shard: torch.Tensor, ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The negatives' exchange: ids (...) clipped to [0, V) → (the
        compact (U, d) rows of the distinct ids in the shard's own dtype,
        each id's position in them as int32 of ``ids``' shape)."""
        vocab = self.vocab_of(shard)
        uids, index, _ = self._unique_reads(ids.clamp(min=0), vocab)
        rows = self._request(shard, uids, shard.dtype, "neg")
        return rows.contiguous(), index.to(torch.int32).reshape(ids.shape)

    # -- the sparse gradient exchange --------------------------------------
    def _pack(self, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """(id, [scale,] row) byte rows in the wire dtype."""
        parts = [_as_bytes(ids.to(torch.int32)[:, None])]
        if self.grad_wire_dtype == torch.int8:
            amax = rows.abs().amax(dim=1, keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0,
                                torch.ones_like(amax))
            q = torch.clamp(torch.round(rows / scale), -127, 127)
            parts += [_as_bytes(scale), _as_bytes(q.to(torch.int8))]
        else:
            parts.append(_as_bytes(rows.to(self.grad_wire_dtype)))
        return torch.cat(parts, dim=1)

    def _unpack(self, b: torch.Tensor, d: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = _from_bytes(b[:, :4], torch.int32, 1).reshape(-1)
        if self.grad_wire_dtype == torch.int8:
            scale = _from_bytes(b[:, 4:8], torch.float32, 1)
            q = _from_bytes(b[:, 8:], torch.int8, d)
            return ids, q.float() * scale
        w = self.grad_wire_dtype
        return ids, _from_bytes(b[:, 4:], w, d).float()

    def exchange_grads(self, ids: torch.Tensor, rows: torch.Tensor,
                       vocab: int, *, unique: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(id, grad row) pairs in global id space → the final unique
        pairs of this rank's shard: (shard-relative ids (u,) int32
        ascending, rows (u, d) fp32), equal on every replica of the shard.
        ``unique``: the pairs are already unique and ascending (the train
        step's K5 output), so the local run-sum is skipped. Ids < 0 or
        ≥ ``vocab`` are dropped."""
        d = rows.shape[1]
        ids = ids.reshape(-1)
        if not unique:
            ids, rows = unique_pairs(rows.float(), ids)
        keep = ids < vocab
        if not bool(keep.all()):
            ids, rows = ids[keep], rows[keep]
        if self.unique_capacity is not None:
            ids = ids[:self.unique_capacity]
            rows = rows[:self.unique_capacity]
        lo, hi = self.shard_range(vocab)
        vs = hi - lo
        counts = self._owner_counts(ids, vs)
        got, _ = self.mesh.all_to_all_v(self._pack(ids, rows.float()),
                                        counts, self.group_axes,
                                        "grad_group")
        rids, rrows = self._unpack(got, d)
        uids = rids.to(torch.int32) - lo
        urows = rrows
        if self.group_size > 1 or not unique:
            # pairs from several senders: the owner's sorted run-sum (a
            # group of one received its own unique pairs back)
            order, keys = sort_pairs(uids)
            uids, urows = run_totals(rrows, order, keys)
        if self.replicas > 1:
            parts = self.mesh.all_gather_v(self._pack(uids, urows),
                                           self.dp_axes, "grad_replicas")
            rids, rrows = self._unpack(torch.cat(parts), d)
            order, keys = sort_pairs(rids)
            uids, urows = run_totals(rrows, order, keys)
        return uids, urows

    # -- logit sharing across ranks ----------------------------------------
    def share_tokens(self, layout: ShareLayout, o: torch.Tensor,
                     pos: torch.Tensor, valid: torch.Tensor,
                     neg_ids: torch.Tensor):
        """The tokens of the segments this rank computes (``layout``, this
        rank's :class:`~repro_torch.kernels.neg_logits.ops.ShareLayout`):
        o (T, d), pos (T,) fp32 positive logits, valid (T,), neg_ids (T, R)
        → (o, pos, valid fp32, neg_ids int32, anchor) of its tokens from
        ``layout.keep`` on followed by the ``layout.borrow`` tokens of the
        ranks after it, differentiable in o and pos. The first ``keep``
        tokens go to their segment's owner; in backward their grads come
        back. ``anchor`` is a zero scalar to add to the loss, so that
        every rank runs the backward exchange (None when no rank sends:
        nothing is exchanged then)."""
        k = layout.keep
        valid = valid.to(torch.float32)
        neg_ids = neg_ids.to(torch.int32)
        if not layout.moves:
            return o[k:], pos[k:], valid[k:], neg_ids[k:], None
        counts = [0] * self.world
        counts[layout.owner] = k
        o_in, pos_in, v_in, ids_in, anchor = _ShareTokensFn.apply(
            o[:k], pos[:k], valid[:k], neg_ids[:k], self, counts)
        return (torch.cat([o[k:], o_in]), torch.cat([pos[k:], pos_in]),
                torch.cat([valid[k:], v_in]),
                torch.cat([neg_ids[k:], ids_in]), anchor)

    # -- the dense half of a training step ---------------------------------
    def valid_total(self, valid: torch.Tensor) -> torch.Tensor:
        """The valid tokens of the global batch, an fp32 scalar on the
        device (every rank's count, summed in rank order)."""
        n = valid.to(torch.float32).sum().reshape(1)
        return self.mesh.sum_in_order(n, self.mesh.axes,
                                      "loss").reshape(())

    def reduce_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss: every rank's part (its tokens' sum over the
        global count), summed in rank order."""
        return self.mesh.sum_in_order(loss.detach().float().reshape(1),
                                      self.mesh.axes, "loss").reshape(())

    def reduce_dense(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The dense grads summed over all ranks in rank order, in fp32
        (every rank gets the same bits; a world of one keeps its own)."""
        if self.world == 1:
            return grads
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1).float() for k in names])
        total = self.mesh.sum_in_order(flat, self.mesh.axes, "dense")
        out, lo = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = total[lo:lo + n].view(grads[k].shape)
            lo += n
        return out

    @torch.no_grad()
    def check_replicas(self, tensors: Sequence[torch.Tensor],
                       table: Sequence[torch.Tensor]) -> None:
        """Raise :class:`ReplicaDivergence` unless the dense ``tensors``
        (params and moments) hold the same bits on every rank and the
        shard's ``table`` tensors (master, accumulator) the same bits on
        every replica of the shard: exact checksums of their bit patterns
        (per tensor for the dense ones, per row for the table's),
        gathered and compared."""
        if self.world > 1:
            sums = torch.stack([bit_checksum(t) for t in tensors])
            got = self.mesh.all_gather_v(sums, self.mesh.axes, "check")
            if any(not torch.equal(g, got[0]) for g in got[1:]):
                raise ReplicaDivergence("the dense replicas differ")
            self.checks["dense"] += 1
        if self.replicas > 1:
            rows = []
            for t in table:
                for lo in range(0, t.shape[0], _CHECK_ROWS):
                    b = _bits(t[lo:lo + _CHECK_ROWS])
                    w = torch.arange(1, b.shape[1] + 1, device=b.device,
                                     dtype=torch.int64)
                    rows.append(torch.stack([b.sum(1), (b * w).sum(1)], 1))
            mine = torch.cat(rows)
            got = self.mesh.all_gather_v(mine, self.dp_axes, "check")
            if any(not torch.equal(g, got[0]) for g in got[1:]):
                raise ReplicaDivergence("the data replicas of a shard "
                                        "differ")
            self.checks["table"] += 1

    # -- the standalone differentiable lookup -------------------------------
    def __call__(self, shard: torch.Tensor, ids: torch.Tensor
                 ) -> torch.Tensor:
        return _HSPLookupFn.apply(shard, ids, self)


class _HSPLookupFn(torch.autograd.Function):
    """Forward :meth:`HSPLookup.gather`; backward the sparse gradient
    exchange of the row grads, landed in a dense (V/I, d) shard grad."""

    @staticmethod
    def forward(ctx, shard, ids, hsp):
        ctx.save_for_backward(ids)
        ctx.hsp, ctx.shape, ctx.dtype = hsp, shard.shape, shard.dtype
        return hsp.gather(shard, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        hsp = ctx.hsp
        vs, d = ctx.shape
        vocab = vs * hsp.group_size
        flat = ids.reshape(-1).to(torch.int64)
        flat = torch.where(flat >= 0, flat.clamp(max=vocab - 1), flat)
        u, rows = hsp.exchange_grads(flat, g.reshape(-1, d).float(), vocab)
        dshard = torch.zeros((vs, d), dtype=torch.float32, device=g.device)
        dshard[u.long()] = rows
        return dshard.to(ctx.dtype), None, None


class _ShareTokensFn(torch.autograd.Function):
    """Forward: (o, pos, valid, ids) rows to the members ``counts`` names,
    as one byte row a token (kind ``share_tokens``); the rows received, in
    rank order, and a zero anchor. Backward: their o and pos grads back to
    the ranks they came from (kind ``share_grads``); o's grad travels in
    o's dtype, the dtype autograd hands it in."""

    @staticmethod
    def forward(ctx, o, pos, valid, ids, hsp, counts):
        mesh = hsp.mesh
        D, R = o.shape[1], ids.shape[1]
        msg = torch.cat([_as_bytes(o), _as_bytes(pos.float()[:, None]),
                         _as_bytes(valid[:, None]), _as_bytes(ids)], dim=1)
        got, rcounts = mesh.all_to_all_v(msg, counts, mesh.axes,
                                         "share_tokens")
        w = D * o.element_size()
        o_in = _from_bytes(got[:, :w], o.dtype, D)
        pos_in = _from_bytes(got[:, w:w + 4], torch.float32, 1).reshape(-1)
        v_in = _from_bytes(got[:, w + 4:w + 8], torch.float32, 1).reshape(-1)
        ids_in = _from_bytes(got[:, w + 8:], torch.int32, R)
        ctx.hsp, ctx.rcounts, ctx.dtype, ctx.D, ctx.w = (hsp, rcounts,
                                                         o.dtype, D, w)
        ctx.n_in = got.shape[0]
        ctx.mark_non_differentiable(v_in, ids_in)
        return o_in, pos_in, v_in, ids_in, pos.new_zeros((),
                                                          dtype=torch.float32)

    @staticmethod
    def backward(ctx, g_o, g_pos, _v, _ids, _anchor):
        mesh, n, D, w = ctx.hsp.mesh, ctx.n_in, ctx.D, ctx.w
        if g_o is None:
            g_o = torch.zeros((n, D), dtype=ctx.dtype, device=mesh.device)
        if g_pos is None:
            g_pos = torch.zeros((n,), dtype=torch.float32, device=mesh.device)
        msg = torch.cat([_as_bytes(g_o.to(ctx.dtype)),
                         _as_bytes(g_pos.float()[:, None])], dim=1)
        back, _ = mesh.all_to_all_v(msg, ctx.rcounts, mesh.axes,
                                    "share_grads")
        return (_from_bytes(back[:, :w], ctx.dtype, D),
                _from_bytes(back[:, w:], torch.float32, 1).reshape(-1),
                None, None, None, None)


def make_hsp_lookup(mesh, *, group_axes: Tuple[str, ...] = ("model",),
                    dp_axes: Tuple[str, ...] = ("data",),
                    compute_dtype=torch.bfloat16,
                    unique_capacity: Optional[int] = None,
                    grad_wire_dtype=torch.float32) -> HSPLookup:
    """An HSP lookup bound to ``mesh`` (a :class:`~repro_torch.launch.mesh.
    Mesh`): the table sharded over ``group_axes``, replicated over
    ``dp_axes``. The global-sharding baseline is ``group_axes=("data",
    "model"), dp_axes=()``. ``unique_capacity`` bounds each rank's sparse
    gradient message to that many unique rows (None = lossless);
    ``grad_wire_dtype`` is the exchanged gradient rows' dtype (fp32, bf16,
    int8 with a per-row scale)."""
    return HSPLookup(mesh, group_axes=tuple(group_axes),
                     dp_axes=tuple(dp_axes), compute_dtype=compute_dtype,
                     unique_capacity=unique_capacity,
                     grad_wire_dtype=grad_wire_dtype)
