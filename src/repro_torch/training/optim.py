"""Optimizers of the GR training step (the port of ``repro.training.optim``).

AdamW for the dense backbone (paper Appendix A: lr 4e-3, no weight decay
for GR) and the row-sparse Eq.-1 AdaGrad for the embedding table (with
the dense Eq.-1 :func:`adagrad_update` for whole parameters). All
update in place: the dense parameters and moments where they lie, and the
table's master, accumulator and shadow at the touched rows only — the
(V, D) tables are never copied.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

from repro_torch.embedding.tables import ShadowedTable
from repro_torch.kernels.jagged_lookup.ops import unique_pairs

Params = Dict[str, torch.Tensor]

#: Rows per pass of the sparse update (128 K rows: 512 MB per fp32
#: temporary at d 1024).
_ROW_CHUNK = 1 << 17


class AdamWState(NamedTuple):
    """First and second moments by parameter name, and the step count."""
    mu: Params
    nu: Params
    count: int


def adamw_init(params: Union[Params, torch.nn.Module],
               dtype=torch.float32) -> AdamWState:
    named = _named(params)
    # zeros_like: a sharded parameter's moments are sharded like it
    return AdamWState(
        mu={n: torch.zeros_like(p, dtype=dtype).detach()
            for n, p in named.items()},
        nu={n: torch.zeros_like(p, dtype=dtype).detach()
            for n, p in named.items()},
        count=0)


def _named(params: Union[Params, torch.nn.Module]) -> Params:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@torch.no_grad()
def adamw_update(grads: Params, state: AdamWState,
                 params: Union[Params, torch.nn.Module], *,
                 lr: float = 4e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0) -> AdamWState:
    """One AdamW step in the reference's fp32 arithmetic, in place on the
    parameters and the moments (cast back to their dtypes); returns the
    state with the count advanced."""
    named = _named(params)
    c = state.count + 1
    dev = next(iter(named.values())).device
    c32 = torch.tensor(float(c), dtype=torch.float32, device=dev)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** c32
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** c32
    for name, p in named.items():
        g = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        step = lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.float()
        p.copy_((p.float() - step).to(p.dtype))
        m.copy_(m32)
        v.copy_(v32)
    return state._replace(count=c)


class AdaGradState(NamedTuple):
    """The accumulator S of Eq. 1, by parameter name."""
    accum: Params


def adagrad_init(params: Union[Params, torch.nn.Module], init: float = 0.0,
                 dtype=torch.float32) -> AdaGradState:
    return AdaGradState(accum={
        n: torch.full(p.shape, init, dtype=dtype, device=p.device)
        for n, p in _named(params).items()})


@torch.no_grad()
def adagrad_update(grads: Params, state: AdaGradState,
                   params: Union[Params, torch.nn.Module], *,
                   lr: float = 4e-3, eps: float = 1e-10) -> AdaGradState:
    """Paper Eq. 1 on dense parameters, S += g², p −= lr·g·rsqrt(S + eps),
    in fp32 in the reference's order, in place on the parameters and the
    accumulators (cast back to their dtypes); returns the state."""
    for name, p in _named(params).items():
        g = grads[name].float()
        s = state.accum[name]
        s32 = s.float() + g * g
        p.copy_((p.float() - lr * g * torch.rsqrt(s32 + eps)).to(p.dtype))
        s.copy_(s32)
    return state


@torch.no_grad()
def adagrad_sparse_update(table: ShadowedTable, ids: torch.Tensor,
                          grad_rows: torch.Tensor, *, lr: float = 4e-3,
                          eps: float = 1e-10) -> ShadowedTable:
    """Row-sparse Eq.-1 AdaGrad over (id, grad-row) pairs, in place.

    ``ids`` (n,) (< 0 = empty, duplicates allowed) and ``grad_rows``
    (n, D) are deduplicated through the sorted run-sum (K6), then applied
    by :func:`adagrad_apply_unique`."""
    if ids.numel() == 0:
        return table
    V = table.master.shape[0]
    u, g = unique_pairs(grad_rows, torch.where(ids < V, ids, -1))
    return adagrad_apply_unique(table, u, g, lr=lr, eps=eps)


@torch.no_grad()
def adagrad_apply_unique(table: ShadowedTable, ids: torch.Tensor,
                         grad_rows: torch.Tensor, *, lr: float = 4e-3,
                         eps: float = 1e-10) -> ShadowedTable:
    """Eq.-1 AdaGrad over unique pairs, in place: ``ids`` (u,) distinct and
    in [0, V) (what ``unique_pairs`` returns), ``grad_rows`` (u, D) fp32.
    Master, accumulator and shadow are rewritten at only those rows with
    the reference's fp32 ops in its order. The shadow rows are re-gathered
    from the written master rows, so ``shadow == master.to(qdtype)`` stays
    bitwise true everywhere."""
    # elementwise, so chunks of rows give the same bits as one pass and
    # bound the temporaries at production batch sizes
    for lo in range(0, ids.numel(), _ROW_CHUNK):
        idx = ids[lo:lo + _ROW_CHUNK].long()
        gc = grad_rows[lo:lo + _ROW_CHUNK]
        s_new = table.accum[idx] + gc * gc
        delta = -lr * gc * torch.rsqrt(s_new + eps)
        table.master[idx] = table.master[idx] + delta
        table.accum[idx] = s_new
        if table.shadow is not None:
            table.shadow[idx] = table.master[idx].to(table.shadow.dtype)
    return table
