"""The train steps (the port of ``repro.training.trainer``).

:func:`make_lm_train_step` is the step of the 10 assigned LM
architectures: gradient accumulation over microbatches in ``accum_dtype``
(one microbatch's activations at a time), then AdamW.

The rest of this module is the GR train step.

:func:`make_gr_stages` factors the step into the Algorithm-1 (§4.2.3)
device stages — ``emb_fwd`` (input-side gather, the τ=1 stale read),
``dense_fwd_bwd`` (HSTU stack + fused sampled-softmax loss + grads),
``emb_bwd`` (deduplicated sparse (id, row) pairs + AdamW + row-sparse
AdaGrad) and ``sparse_apply`` (the deferred τ=1 landing) — and
:func:`make_gr_train_step` composes them, in the sync schedule or the τ=1
one (``semi_async``).

One design point the reference does not face: its autodiff yields dense
(V, D) fp32 table grads (three of them at τ=1), 17.2 GB each at vocab 2²²,
d 1024, beside 42.9 GB of tables on an 80 GB card. Here the table grads
stay sparse end to end, as (id, row) contributions from three sources —
the negative rows w·o/τ of the fused kernel's backward, the input rows
(the grad of the gathered x) and the label rows — which one sorted run-sum
reduces to the unique (id, row) pairs the reference's
``_table_grad_pairs`` returns (equal per id up to fp32 summation order):
K5 with the negative rows left in factored form (``scatter_impl="fused"``,
the default: the (T·R, D) rows are never built) or K6 over built rows
(``"two_pass"``); the two give the same bits. The baseline and segmented
negative paths hand over their rows (K9's dn) ready, and K6 reduces them
as it does two-pass rows. The τ=1 carry holds only those unique pairs,
and the stale master is never copied: ``emb_fwd`` gathers x before the
pending pairs land in place.

A bound ``lookup_fn`` (the loss's input and label lookup, e.g. K7's
``jagged_lookup``) gathers x in ``emb_fwd`` and the labels in
``dense_fwd_bwd``; the gathered rows stay leaves whose grads join the
sparse pairs, as the plain gather's do (rows of ids < 0, which the lookup
gives as zeros, get no gradient). The reference instead keeps a custom
lookup inline in the dense stage, differentiated against the stale master:
the same values and per-id grads (a declared divergence).
"""
from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.embedding.tables import (ShadowedTable, live_shadow,
                                          make_shadowed)
from repro_torch.kernels.jagged_lookup.ops import (run_totals, sort_pairs,
                                                   weighted_run_totals)
from repro_torch.kernels.neg_logits import TableGradSink
from repro_torch.models.gr import GRModel
from repro_torch.training import optim as O

Batch = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# LM trainer
# --------------------------------------------------------------------------

def _laid_out_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A sharded parameter's grad in the parameter's layout (a DTensor
    grad may come partial or otherwise placed; the accumulation and AdamW
    update in place); a plain grad as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


class LMTrainState(NamedTuple):
    params: torch.nn.Module
    opt: O.AdamWState
    step: int


def lm_train_state(params: torch.nn.Module,
                   opt_dtype=torch.float32) -> LMTrainState:
    return LMTrainState(params=params, opt=O.adamw_init(params, opt_dtype),
                        step=0)


def make_lm_train_step(loss_fn: Callable[[torch.nn.Module, Batch],
                                         torch.Tensor], *,
                       num_microbatches: int = 1,
                       accum_dtype=torch.float32, lr: float = 3e-4,
                       weight_decay: float = 0.1, b1: float = 0.9,
                       b2: float = 0.95):
    """``loss_fn(params, microbatch)`` → scalar. Returns ``train_step(state,
    batch)`` → (state, {"loss"}), which updates the parameters and moments
    in place. With ``num_microbatches`` > 1 the batch's rows are split in
    that many consecutive microbatches; each one's grads are added to
    zeros in ``accum_dtype`` in order, then scaled by 1/n (the
    reference's scan of grads), and the losses summed in fp32 and scaled
    alike. AdamW with the reference's LM defaults."""

    def grads_of(model, plist, mbatch):
        loss = loss_fn(model, mbatch)
        gs = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else
                               _laid_out_like(g, p)
                               for p, g in zip(plist, gs)]

    def train_step(state: LMTrainState, batch: Batch):
        model = state.params
        named = dict(model.named_parameters())
        names, plist = list(named), list(named.values())
        if num_microbatches <= 1:
            loss, gs = grads_of(model, plist, batch)
            grads = dict(zip(names, gs))
        else:
            B = next(iter(batch.values())).shape[0]
            if B % num_microbatches:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"{num_microbatches} microbatches")
            mb = B // num_microbatches
            grads = {n: torch.zeros_like(p, dtype=accum_dtype)
                     for n, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=plist[0].device)
            for i in range(num_microbatches):
                mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, gs = grads_of(model, plist, mbatch)
                for n, g in zip(names, gs):
                    grads[n].add_(g.to(accum_dtype))
                del gs
                loss = loss + l_i
            inv = 1.0 / num_microbatches
            for g in grads.values():
                g.mul_(inv)
            loss = loss * inv
        opt = O.adamw_update(grads, state.opt, model, lr=lr, b1=b1, b2=b2,
                             weight_decay=weight_decay)
        return LMTrainState(model, opt, state.step + 1), {"loss": loss}

    return train_step


# --------------------------------------------------------------------------
# GR trainer
# --------------------------------------------------------------------------


class GRTrainState(NamedTuple):
    dense: GRModel
    dense_opt: O.AdamWState
    table: ShadowedTable            # fp32 master + fp16 shadow + AdaGrad S
    pending_ids: torch.Tensor       # (n,) int32 unique ids ≥ 0 (τ=1 carry)
    pending_rows: torch.Tensor      # (n, D) fp32 their grad rows
    step: int


def gr_train_state(dense: GRModel, table, opt_dtype=torch.float32, *,
                   qdtype=torch.float16) -> GRTrainState:
    """``table`` is the fp32 master (a ``qdtype`` shadow, None = none, and
    a zero accumulator are derived from it) or a ready ShadowedTable. The
    τ=1 carry starts empty."""
    st = (table if isinstance(table, ShadowedTable)
          else make_shadowed(table, qdtype=qdtype))
    D = st.master.shape[1]
    dev = st.master.device
    return GRTrainState(
        dense=dense, dense_opt=O.adamw_init(dense, opt_dtype), table=st,
        pending_ids=torch.zeros((0,), dtype=torch.int32, device=dev),
        pending_rows=torch.zeros((0, D), dtype=torch.float32, device=dev),
        step=0)


def clone_state(state: GRTrainState) -> GRTrainState:
    """A copy of ``state`` that later steps do not touch: the train step
    updates the dense params, the moments and the table in place."""
    opt = state.dense_opt
    return GRTrainState(
        dense=copy.deepcopy(state.dense),
        dense_opt=opt._replace(mu={k: v.clone() for k, v in opt.mu.items()},
                               nu={k: v.clone() for k, v in opt.nu.items()}),
        table=ShadowedTable(*(None if t is None else t.clone()
                              for t in state.table)),
        pending_ids=state.pending_ids.clone(),
        pending_rows=state.pending_rows.clone(), step=state.step)


def state_tensors(state: GRTrainState) -> List[torch.Tensor]:
    """Every tensor of ``state``, in a fixed order: dense params, AdamW
    moments, master, shadow (when there is one), accumulator and the τ=1
    carry."""
    return [*(p.detach() for p in state.dense.parameters()),
            *state.dense_opt.mu.values(), *state.dense_opt.nu.values(),
            *(t for t in state.table if t is not None),
            state.pending_ids, state.pending_rows]


def gr_pending_slots(batch) -> int:
    """Upper bound on the τ=1 carry of a batch: one pair per table read
    (input ids + labels + negatives). The port's carry holds only the
    unique pairs, so it never reaches the bound when ids repeat."""
    return int(np.prod(batch["ids"].shape) + np.prod(batch["labels"].shape)
               + np.prod(batch["neg_ids"].shape))


def host_unique_candidates(batch, vocab: int):
    """Host-side (numpy) candidate dedup: every table read of a batch
    (input ids, labels, negatives), clipped and sorted. Returns
    ``(sorted, first, counts)``: ``sorted[first]`` are the unique ids and
    ``counts[first]`` their per-batch frequencies (0 elsewhere)."""
    cand = np.concatenate([
        np.asarray(batch["ids"]).reshape(-1),
        np.asarray(batch["labels"]).reshape(-1),
        np.asarray(batch["neg_ids"]).reshape(-1)]).astype(np.int32)
    cand = np.clip(cand, 0, vocab - 1)
    s = np.sort(cand)
    first = np.concatenate([np.ones((1,), bool), s[1:] != s[:-1]])
    starts = np.flatnonzero(first)
    counts = np.zeros(s.shape, np.int64)
    counts[starts] = np.diff(np.append(starts, s.size))
    return s, first, counts


class TableContribs(NamedTuple):
    """Every table-grad contribution of one batch, before deduplication:
    ``ids`` (n,) int32 of the slots [negatives (T·R), input rows, label
    rows]; ``rows`` (m, D) fp32 the ready rows of the last m slots; ``neg``
    the negative slots' rows in factored form ``(w, o, scale)`` for K5
    (``scatter_impl="fused"``, m = n − T·R), or None when they are among
    ``rows`` (``"two_pass"``, m = n)."""
    ids: torch.Tensor
    rows: torch.Tensor
    neg: Optional[Tuple[torch.Tensor, torch.Tensor, float]]


def _table_grad_pairs(c: TableContribs, vocab: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch's table-grad contributions → the unique pairs (ids (u,)
    int32 ascending, rows (u, D) fp32), one device sort and one sorted
    run-sum over all of them: K5 when the negative rows are factored, K6
    when they are built. Ids are clipped to [0, vocab) as the reference
    clips its candidates, so every candidate id appears, with a zero row
    where no gradient reached it."""
    order, keys = sort_pairs(c.ids.clamp(0, vocab - 1))
    if c.neg is None:
        return run_totals(c.rows, order, keys)
    w, o, scale = c.neg
    return weighted_run_totals(o, w, c.rows, order, keys, scale=scale)


def to_device(batch: Dict[str, Any], device, *, pin: bool = False) -> Batch:
    """A loader batch (numpy) as tensors on ``device``; ``weights`` (host
    gradient weights) stay out. ``pin``: copy through pinned host memory
    with ``non_blocking``, on the caller's current stream."""
    out = {}
    for k, v in batch.items():
        if k == "weights":
            continue
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if pin
                  else t.to(device))
    return out


class GRDenseOut(NamedTuple):
    """Artifact flowing dense_fwd_bwd → emb_bwd (one batch).
    ``table_contribs`` holds the batch's one :class:`TableContribs`, which
    emb_bwd pops, so its buffers are freed once they are reduced."""
    loss: torch.Tensor
    grads_dense: Dict[str, torch.Tensor]
    table_contribs: List[TableContribs]


class GRStages(NamedTuple):
    """The staged GR train step (Algorithm 1 device-stage vocabulary).

    emb_fwd(master, batch) -> x | None
        Input-side gather; at τ=1 it runs before the previous batch's
        pairs land (the stale read). None in the sync schedule.
    dense_fwd_bwd(dense, table, batch, x=None) -> GRDenseOut
        HSTU stack + fused loss + grads of the dense params and the
        sparse table contributions.
    emb_bwd(dense, dense_opt, table, dout, batch, *, apply_sparse)
        -> (dense, opt, table, p_ids, p_rows)
        Unique pairs (a device sort, then K5, or K6 for two-pass rows) +
        AdamW + (optionally deferred) AdaGrad.
    sparse_apply(table, p_ids, p_rows) -> table
        The deferred landing of pending pairs (Algorithm 1 line 3); the
        pairs are emb_bwd's, already unique, so it runs no second K6.
    dense_reduce(dout) -> dout
        Over a sharded table (``hsp``), the loss and the dense grads summed
        over all ranks in rank order; the identity otherwise.
    """
    emb_fwd: Callable
    dense_fwd_bwd: Callable
    emb_bwd: Callable
    sparse_apply: Callable
    dense_reduce: Callable


def make_gr_stages(loss_fn: Callable[..., torch.Tensor], *,
                   input_gather: Callable,
                   lookup_fn: Optional[Callable] = None,
                   lr_dense: float = 4e-3, lr_sparse: float = 4e-3,
                   semi_async: bool = True, hsp=None) -> GRStages:
    """``loss_fn(dense, master, batch, *, x_emb, pos_emb, shadow,
    table_grad_pairs)`` → scalar (``GRBundle.loss`` with its modes bound);
    ``input_gather(master, batch)`` → x (``GRBundle.input_gather``, with
    the same ``lookup_fn`` bound); ``lookup_fn(master, ids)`` gathers the
    label rows (None: a plain gather + cast). The port always gathers x as
    its own stage, so the reference's inline stale-table mode has no
    counterpart: in place, the stale master exists only until the pending
    pairs land.

    ``hsp`` (a :class:`~repro_torch.core.hsp.HSPLookup`, also bound in the
    loss and as ``lookup_fn``): the table is this rank's shard. emb_bwd
    hands the batch's unique pairs (global ids) to the sparse gradient
    exchange and lands the shard's final pairs (shard-relative ids, the
    τ=1 carry too), then checks that the dense replicas and the shard's
    data replicas agree; dense_reduce sums the loss and the dense grads
    over all ranks."""

    def emb_fwd(master, batch):
        return input_gather(master, batch) if semi_async else None

    def dense_fwd_bwd(dense: GRModel, table: ShadowedTable, batch,
                      x=None) -> GRDenseOut:
        master = table.master
        if x is None:
            x = input_gather(master, batch)
        x = x.detach().requires_grad_()
        pos = (lookup_fn(master, batch["labels"]) if lookup_fn is not None
               else master[batch["labels"].long()].to(x.dtype))
        pos = pos.detach().requires_grad_()
        n_in, n_lab = batch["ids"].numel(), batch["labels"].numel()
        sink = TableGradSink(extra_rows=n_in + n_lab)
        names, params = zip(*[(n, p) for n, p in dense.named_parameters()
                              if p.requires_grad])
        loss = loss_fn(dense, master, batch, x_emb=x, pos_emb=pos,
                       shadow=live_shadow(table), table_grad_pairs=sink)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip([x, pos, *params], torch.autograd.grad(
                     loss, [x, pos, *params], allow_unused=True))]
        if lookup_fn is not None:
            # the lookup's zero rows of ids < 0 pass no gradient
            for i, key in enumerate(("ids", "labels")):
                keep = (batch[key] >= 0)[..., None]
                grads[i] = torch.where(keep, grads[i],
                                       torch.zeros_like(grads[i]))
        # the input and label rows join the negative slots in the sink's
        # buffer: one stream of slots for the whole batch
        D = master.shape[1]
        rows = sink.rows
        if rows is None:
            rows = master.new_empty((n_in + n_lab, D))
        n_ready = rows.shape[0] - n_in - n_lab
        rows[n_ready:n_ready + n_in] = grads[0].reshape(-1, D)
        rows[n_ready + n_in:] = grads[1].reshape(-1, D)
        ids = torch.cat([i.reshape(-1).to(torch.int32) for i in
                         ([] if sink.ids is None else [sink.ids])
                         + [batch["ids"], batch["labels"]]])
        return GRDenseOut(loss.detach(), dict(zip(names, grads[2:])),
                          [TableContribs(ids, rows, sink.neg)])

    def emb_bwd(dense, dense_opt, table: ShadowedTable, dout: GRDenseOut,
                batch, *, apply_sparse: bool = True):
        vocab = (table.master.shape[0] if hsp is None
                 else hsp.vocab_of(table.master))
        p_ids, p_rows = _table_grad_pairs(dout.table_contribs.pop(), vocab)
        if hsp is not None:
            p_ids, p_rows = hsp.exchange_grads(p_ids, p_rows, vocab,
                                               unique=True)
        new_opt = O.adamw_update(dout.grads_dense, dense_opt, dense,
                                 lr=lr_dense, weight_decay=0.0)
        if apply_sparse:
            table = O.adagrad_apply_unique(table, p_ids, p_rows,
                                           lr=lr_sparse)
        if hsp is not None:
            hsp.check_replicas(
                [*(p.detach() for p in dense.parameters()),
                 *new_opt.mu.values(), *new_opt.nu.values()],
                [table.master, table.accum])
        return dense, new_opt, table, p_ids, p_rows

    def sparse_apply(table: ShadowedTable, p_ids, p_rows):
        return O.adagrad_apply_unique(table, p_ids, p_rows, lr=lr_sparse)

    def dense_reduce(dout: GRDenseOut) -> GRDenseOut:
        if hsp is None:
            return dout
        return dout._replace(loss=hsp.reduce_loss(dout.loss),
                             grads_dense=hsp.reduce_dense(dout.grads_dense))

    return GRStages(emb_fwd, dense_fwd_bwd, emb_bwd, sparse_apply,
                    dense_reduce)


def make_gr_train_step(loss_fn: Callable[..., torch.Tensor], *,
                       input_gather: Callable,
                       lookup_fn: Optional[Callable] = None,
                       lr_dense: float = 4e-3, lr_sparse: float = 4e-3,
                       semi_async: bool = True, stage_times: bool = False,
                       hsp=None):
    """train_step(state, batch) → (state, {"loss"}), the flat composition
    of the :func:`make_gr_stages` stages. The dense params, the optimizer
    moments and the table are updated in place; the returned state holds
    the same tensors with the new carry and step.

    semi_async=True is the τ=1 schedule: x is gathered from the master
    first, then last step's pairs land, then the dense stream runs, and
    this step's unique pairs become the carry. ``stage_times`` adds each
    stage's wall seconds to the metrics (host clock around work that ends
    in a device synchronise: it costs the overlap of the stages). ``hsp``:
    see :func:`make_gr_stages`."""
    st = make_gr_stages(loss_fn, input_gather=input_gather,
                        lookup_fn=lookup_fn, lr_dense=lr_dense,
                        lr_sparse=lr_sparse, semi_async=semi_async, hsp=hsp)

    def train_step(state: GRTrainState, batch: Batch):
        tbl = state.table
        times: Dict[str, float] = {}

        def timed(name, fn, *a, **kw):
            if not stage_times:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if tbl.master.is_cuda:
                torch.cuda.synchronize(tbl.master.device)
            times[f"{name}_s"] = time.perf_counter() - t0
            return out

        if semi_async:
            x = timed("emb_fwd", st.emb_fwd, tbl.master, batch)
            tbl = timed("sparse_apply", st.sparse_apply, tbl,
                        state.pending_ids, state.pending_rows)
            dout = st.dense_reduce(timed("dense_fwd_bwd", st.dense_fwd_bwd,
                                         state.dense, tbl, batch, x))
            dense, opt, tbl, p_ids, p_rows = timed(
                "emb_bwd", st.emb_bwd, state.dense, state.dense_opt, tbl,
                dout, batch, apply_sparse=False)
        else:
            dout = st.dense_reduce(timed("dense_fwd_bwd", st.dense_fwd_bwd,
                                         state.dense, tbl, batch))
            dense, opt, tbl, _, _ = timed(
                "emb_bwd", st.emb_bwd, state.dense, state.dense_opt, tbl,
                dout, batch, apply_sparse=True)
            p_ids = state.pending_ids[:0]
            p_rows = state.pending_rows[:0]
        return (GRTrainState(dense, opt, tbl, p_ids, p_rows, state.step + 1),
                {"loss": dout.loss, **times})

    return train_step
