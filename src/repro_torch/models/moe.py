"""Mixture-of-Experts layer (the port of ``repro.models.moe``): top-k router
and the capacity-bounded sort dispatch.

Dispatch is index-based (stable sort → gather → batched expert matmul →
combine), not a one-hot einsum: the one-hot dispatch tensor is O(T·E·C).
Capacity is per sample, C = ceil(S·k/E·cf), at least 1 (decode dispatches
one token) and at most S. Expert weights carry a leading E dim.

The combine. The reference scatter-adds each kept slot's fp32 output into
its token's row (``.at[].add``), whose order XLA leaves open, and
``index_add_`` on the card has no fixed order either. Here each token
gathers its kept slots' outputs in ascending (expert, rank) order, the
order of the reference's (E, C) table and of its scatter on the CPU, and
adds them one after another from the first: a fixed order, so two runs on
the card give the same bits.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core.sharding import to_local_summed
from repro_torch.models.layers import _normal, has, matmul_f32


class MoE(nn.Module):
    """``init_moe``'s parameters: the ``router`` (d, E) in fp32; ``w_in``,
    ``w_gate`` (E, d, d_expert) at 1/√d and ``w_out`` (E, d_expert, d) at
    1/√(d_expert·2·L); the shared experts' ``shared_w_in``/``_gate``
    (d, n_shared·d_expert) and ``shared_w_out``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device, generator=None):
        super().__init__()
        m = cfg.moe
        d, E, f = cfg.d_model, m.num_experts, m.d_expert
        s_in = 1.0 / math.sqrt(d)
        s_out = 1.0 / math.sqrt(f * 2 * cfg.num_layers)
        self.router = _normal((d, E), s_in, torch.float32, device, generator)
        self.w_in = _normal((E, d, f), s_in, dtype, device, generator)
        self.w_out = _normal((E, f, d), s_out, dtype, device, generator)
        self.w_gate = (_normal((E, d, f), s_in, dtype, device, generator)
                       if cfg.glu else None)
        self.shared_w_in = self.shared_w_out = self.shared_w_gate = None
        if m.num_shared_experts:
            ds = m.num_shared_experts * f
            self.shared_w_in = _normal((d, ds), s_in, dtype, device,
                                       generator)
            self.shared_w_out = _normal((ds, d), s_out, dtype, device,
                                        generator)
            if cfg.glu:
                self.shared_w_gate = _normal((d, ds), s_in, dtype, device,
                                             generator)


@dataclasses.dataclass
class DispatchStats:
    """Slots dispatched and slots dropped for capacity, summed over the
    MoE layers run inside :func:`dispatch_stats`."""
    slots: int = 0
    dropped: int = 0

    @property
    def drop_share(self) -> float:
        return self.dropped / max(self.slots, 1)


_STATS: contextvars.ContextVar[Optional[DispatchStats]] = \
    contextvars.ContextVar("repro_torch_moe_stats", default=None)


@contextlib.contextmanager
def dispatch_stats():
    """Count the slots the MoE layers dispatch and drop (each layer then
    reads its drop count back from the device)."""
    st = DispatchStats()
    tok = _STATS.set(st)
    try:
        yield st
    finally:
        _STATS.reset(tok)


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) → (weights (T, k) fp32 normalised, expert_idx (T, k), the
    Switch load-balance aux loss E·Σ_e f_e·p_e)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    T, E = logits.shape
    counts = torch.zeros((T, E), dtype=torch.float32, device=logits.device)
    counts.scatter_add_(1, idx, torch.ones_like(w))
    f = counts.mean(dim=0)
    pbar = probs.mean(dim=0)
    aux = E * torch.sum(f * pbar)
    return w, idx, aux


def moe_apply(p: MoE, cfg: ArchConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out (B, S, d), aux loss). The dispatch runs per
    sample (the reference vmaps it), so capacity is per sample; the shared
    experts see every token."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_apply_sharded(p, cfg, x)
    m: MoEConfig = cfg.moe
    outs, auxs = zip(*(_moe_tokens(p, cfg, x[b]) for b in range(x.shape[0])))
    out = torch.stack(outs)
    if m.num_shared_experts:
        hs = x @ p.shared_w_in
        if has(p, "shared_w_gate"):
            hs = F.silu(x @ p.shared_w_gate) * hs
        else:
            hs = F.silu(hs)
        out = out + hs @ p.shared_w_out
    return out, torch.stack(auxs).mean()


def _moe_apply_sharded(p: MoE, cfg: ArchConfig, x
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` over a mesh (x a DTensor): the dispatch ranks a
    sample's tokens, so each device takes whole samples, its part of x's
    batch split (every other mesh axis gathered), and every expert (the
    weights gathered), and runs the plain dispatch on its local tensors:
    each sample's routing, capacity and drops are the single process's.
    Data parallel, replicated over the other axes, where the reference
    shards the experts over ``model`` (a declared divergence). The aux
    loss, a mean over samples, is the devices' mean."""
    from types import SimpleNamespace

    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    keep = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in x.placements]
    xl = x.redistribute(mesh, keep).to_local()
    rep = [Replicate()] * mesh.ndim
    # each device's expert grads are its samples' share of the sum
    split = {m for m, pl in enumerate(keep) if isinstance(pl, Shard)}
    local = SimpleNamespace(**{
        n: (None if t is None else
            to_local_summed(t.redistribute(mesh, rep), split)
            if isinstance(t, DTensor) else t)
        for n, t in ((n, getattr(p, n, None)) for n in
                     ("router", "w_in", "w_gate", "w_out", "shared_w_in",
                      "shared_w_gate", "shared_w_out"))})
    out, aux = moe_apply(local, cfg, xl)
    out = DTensor.from_local(out, mesh, keep, run_check=False)
    # the devices' mean as a sum of shares: the backward gives each share
    # the sum's grad (DTensor gives a Partial("avg") the mean's whole grad
    # on every device, n times its share)
    n = math.prod(mesh.size(m) for m in split)
    aux = DTensor.from_local(aux / n, mesh, [
        Partial() if isinstance(pl, Shard) else Replicate()
        for pl in keep], run_check=False)
    return out, aux


def _moe_tokens(p: MoE, cfg: ArchConfig, xt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort-based capacity dispatch over a flat token set xt: (T, d).

    Every (token, slot) assignment is ranked within its expert by a stable
    sort (ties in token order); assignments at rank ≥ C are dropped: their
    destination is E·C, one past the (E, C) table, and is cut off. Table
    entries no slot fills point at row T of the tokens, a zero sentinel.
    Gather → (E, C, d) → expert FFN (fp32 products) → weighted by the
    router → combined per token in a fixed order (module docstring)."""
    m: MoEConfig = cfg.moe
    T, d = xt.shape
    dev = xt.device
    logits = matmul_f32(xt, p.router)
    w, idx, aux = router_topk(logits, m.top_k)                # (T, k)

    k, E = m.top_k, m.num_experts
    cap = int(math.ceil(T * k / E * m.capacity_factor))
    cap = max(1, min(cap, T))
    flat_e = idx.reshape(T * k)
    flat_w = w.reshape(T * k)
    flat_tok = torch.arange(T, dtype=torch.int64,
                            device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)               # by expert
    e_sorted = flat_e[order]
    grp_start = torch.searchsorted(
        e_sorted, torch.arange(E, dtype=e_sorted.dtype, device=dev))
    pos_in_grp = torch.arange(T * k, device=dev) - grp_start[e_sorted]
    keep = pos_in_grp < cap
    dest = torch.where(keep, e_sorted * cap + pos_in_grp, E * cap)
    # kept slots have distinct destinations; the dropped all land on the
    # extra entry E·C, which is cut off
    table_tok = torch.full((E * cap + 1,), T, dtype=torch.int64, device=dev)
    table_w = torch.zeros((E * cap + 1,), dtype=torch.float32, device=dev)
    table_tok[dest] = flat_tok[order]
    table_w = table_w.index_put((dest,), flat_w[order])
    table_tok = table_tok[:-1].view(E, cap)
    table_w = table_w[:-1].view(E, cap)
    st = _STATS.get()
    if st is not None:
        st.slots += T * k
        st.dropped += int((~keep).sum())

    xt_pad = torch.cat([xt, torch.zeros((1, d), dtype=xt.dtype, device=dev)])
    xe = xt_pad[table_tok]                                    # (E, C, d)
    h = matmul_f32(xe, p.w_in)
    if has(p, "w_gate"):
        h = F.silu(matmul_f32(xe, p.w_gate)) * h
    else:
        h = F.silu(h)
    h = h.to(xt.dtype)
    ye = matmul_f32(h, p.w_out) * table_w[..., None]          # (E, C, d)

    # each token's kept slots' rows of ye in ascending (expert, rank)
    # order, then the dropped ones (a zero row, E·C), summed left to right
    src = torch.full((T * k,), E * cap, dtype=torch.int64, device=dev)
    src[order] = dest
    src = torch.sort(src.view(T, k), dim=1).values
    ye_pad = torch.cat([ye.reshape(E * cap, d),
                        torch.zeros((1, d), dtype=ye.dtype, device=dev)])
    out = ye_pad[src[:, 0]]
    for j in range(1, k):
        out = out + ye_pad[src[:, j]]
    return out.to(xt.dtype), aux
