"""GR model = stack of HSTU, FuXi or SASRec blocks over a packed jagged
token buffer (``cfg.gr_block`` picks the block, as the reference's
``_BLOCKS``).

The embedding lookup happens outside this module: the dense model takes
already-looked-up embeddings ``(cap, d)`` plus the jagged structure
(offsets, timestamps). The G packs of a serving micro-batch are a leading
batch axis ``(G, cap, d)``: one forward covers them all, and the attention
kernel takes all G packs in one launch per layer. Training differentiates
through the same forward (:func:`gr_hidden_sharded`, each layer under a
non-reentrant ``torch.utils.checkpoint``); serving runs it under
``torch.no_grad``.

Attention planning: a plan-aware attn_fn (one with ``make_plan``, the
kernel wrapper's :class:`PlannedAttention`) gets one plan per call, built
before the layer loop and shared by every layer. SASRec takes no attn_fn
(its block inlines its softmax attention) and so no plan.

The slot-buffer entries at the end serve the continuous-batching engine:
one user per slot row, R rows a tick, each row a pack of its own (the
reference's vmap over rows, written out), with incremental prefix reuse
for HSTU: :func:`gr_encode_slots` encodes rows cold and fills their K/V
caches, :func:`gr_append_slots` encodes only the appended window against
them, bit for bit what a cold encode of the grown row gives.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.fuxi import FuXiBlock, fuxi_block
from repro_torch.kernels.jagged_attention import ops as attn_ops
from repro_torch.models.hstu import (HSTUBlock, _row_stats, default_attn_fn,
                                     hstu_block, hstu_block_append,
                                     hstu_block_kv)
from repro_torch.models.sasrec import SASRecBlock, sasrec_block

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


#: gr_block → (parameter module, block function)
_BLOCKS = {"hstu": (HSTUBlock, hstu_block), "fuxi": (FuXiBlock, fuxi_block),
           "sasrec": (SASRecBlock, sasrec_block)}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _block(cfg: ArchConfig):
    kind = cfg.gr_block or "hstu"
    if kind not in _BLOCKS:
        raise NotImplementedError(
            f"gr_block={kind!r}: not ported yet (ported: {sorted(_BLOCKS)})")
    return _BLOCKS[kind]


class GRModel(nn.Module):
    """Dense GR parameters: ``blocks`` (one :class:`HSTUBlock`,
    :class:`FuXiBlock` or :class:`SASRecBlock` per layer, the JAX pytree's
    stacked layer axis split out) and the final affine norm. Initialised with ``init_gr``'s
    distributions from ``generator``; ``device=None`` means the card."""

    def __init__(self, cfg: ArchConfig, *, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        block_cls = _block(cfg)[0]
        device = resolve_device(device)
        dtype = dtype or torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            block_cls(cfg, dtype=dtype, device=device, generator=generator)
            for _ in range(cfg.num_layers))
        self.out_ln_w = nn.Parameter(
            torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.out_ln_b = nn.Parameter(
            torch.zeros(cfg.d_model, dtype=dtype, device=device))


def gr_hidden(model: GRModel, cfg: ArchConfig, x: torch.Tensor,
              offsets: torch.Tensor, timestamps: torch.Tensor, *,
              attn_fn: Optional[Callable] = None,
              remat: bool = False) -> torch.Tensor:
    """x (cap, d) or (G, cap, d) packed embeddings → hidden states of the
    same shape. ``remat`` wraps each layer in a non-reentrant
    ``torch.utils.checkpoint``: only the layer inputs are kept, and the
    backward reruns each layer's forward (the reference's
    ``nothing_saveable`` policy)."""
    block_fn = _block(cfg)[1]
    if attn_fn is None:
        attn_fn = default_attn_fn(cfg)
    plan = None
    if hasattr(attn_fn, "make_plan"):
        plan = attn_fn.make_plan(offsets, timestamps, x.shape[-2])
    for bp in model.blocks:
        def layer(x_, bp=bp):
            return block_fn(bp, cfg, x_, offsets, timestamps,
                            attn_fn=attn_fn, plan=plan)
        x = (checkpoint(layer, x, use_reentrant=False)
             if remat and torch.is_grad_enabled() else layer(x))
    return _final_norm(model, cfg, x)


def gr_hidden_sharded(model: GRModel, cfg: ArchConfig, x: torch.Tensor,
                      offsets: torch.Tensor, timestamps: torch.Tensor, *,
                      attn_fn: Optional[Callable] = None,
                      remat: bool = True) -> torch.Tensor:
    """The training forward over G shards: x (G, cap, d), offsets
    (G, S+1), timestamps (G, cap) → (G, cap, d). The reference vmaps a
    per-shard forward; here the G axis is written out, one attention plan
    covers all G packs (built once per step) and each layer's kernels take
    the G packs in one launch."""
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}: expected (G, cap, d)")
    return gr_hidden(model, cfg, x, offsets, timestamps, attn_fn=attn_fn,
                     remat=remat)


def _final_norm(model: GRModel, cfg: ArchConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Final affine layernorm over the hidden stream (row-local)."""
    xf = x.float()
    mu, var = _row_stats(xf)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    y = y * model.out_ln_w.float() + model.out_ln_b.float()
    return y.to(x.dtype)


@torch.no_grad()
def gr_serve_hidden(model: GRModel, cfg: ArchConfig, x, offsets, timestamps,
                    *, attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Inference-mode hidden states (no autograd, no remat); the plan is
    built once per micro-batch and shared by every layer."""
    return gr_hidden(model, cfg, x, offsets, timestamps, attn_fn=attn_fn)


def gr_user_embeddings(model: GRModel, cfg: ArchConfig, x, offsets,
                       timestamps, last_pos: torch.Tensor, *,
                       attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """The hidden state at each sequence's last token: x (cap, d), last_pos
    (S,) → (S, d). Rows past a pack's live sequences gather slot
    ``last_pos[j]`` verbatim; callers ignore them."""
    h = gr_serve_hidden(model, cfg, x, offsets, timestamps, attn_fn=attn_fn)
    return h[last_pos.long()]


def gr_user_embeddings_sharded(model: GRModel, cfg: ArchConfig, x, offsets,
                               timestamps, last_pos: torch.Tensor, *,
                               attn_fn: Optional[Callable] = None
                               ) -> torch.Tensor:
    """Over the G serving packs at once: x (G, cap, d), offsets (G, S+1),
    timestamps (G, cap), last_pos (G, S) → (G, S, d)."""
    h = gr_serve_hidden(model, cfg, x, offsets, timestamps, attn_fn=attn_fn)
    g = torch.arange(h.shape[0], device=h.device)[:, None]
    return h[g, last_pos.long()]


# --------------------------------------------------------------------------
# slot-buffer serving entries: one user per row, incremental prefix reuse
# --------------------------------------------------------------------------

def slot_capacity(seq_len: int) -> int:
    """A slot row's token capacity: ``seq_len`` rounded up to K1-fwd's
    128-row tile, the key block that both the cold launch and the append
    launch walk on a row (the reference's ``serve_attn_block`` picks its
    XLA scan's block per row length instead)."""
    b = attn_ops.KERNEL_BLOCK
    return -(-seq_len // b) * b


def _row_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """(R, 2) int32 offsets of R packs of one row each."""
    lengths = lengths.to(torch.int32)
    return torch.stack([torch.zeros_like(lengths), lengths], dim=-1)


def _last_rows(h: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """h (R, S, d) → (R, d), row r at position max(n_r − 1, 0)."""
    r = torch.arange(h.shape[0], device=h.device)
    return h[r, (n.long() - 1).clamp(min=0)]


def _check_prefix_reuse(cfg: ArchConfig) -> None:
    if (cfg.gr_block or "hstu") != "hstu":
        raise ValueError("prefix reuse requires gr_block='hstu', got "
                         f"{cfg.gr_block!r}")


@torch.no_grad()
def gr_encode_slots(model: GRModel, cfg: ArchConfig, x: torch.Tensor,
                    timestamps: torch.Tensor, lengths: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    rows: torch.Tensor, *,
                    attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Cold tick over R slot rows (HSTU): x (R, S, d), timestamps (R, S),
    lengths (R,) → emb (R, d), the final hidden state at each row's last
    token. The R rows are R packs of one row: one attention plan for the
    tick, one K1-fwd work-list launch per layer over all R. Layer l's K/V
    projections of row r go to ``k_cache[l, rows[r], :S]`` (the caches
    (L, N+1, cap, H, ·), cap = :func:`slot_capacity`). Positions past a
    row's length hold the projections of its padding tokens: finite, and
    masked to exact zeros by every later launch."""
    _check_prefix_reuse(cfg)
    S = x.shape[1]
    offsets = _row_offsets(lengths)
    attn_fn = attn_fn or default_attn_fn(cfg)
    plan = attn_fn.make_plan(offsets, timestamps, S)
    rl = rows.long()
    for layer, bp in enumerate(model.blocks):
        x, k, v = hstu_block_kv(bp, cfg, x, offsets, timestamps,
                                attn_fn=attn_fn, plan=plan)
        k_cache[layer, rl, :S] = k
        v_cache[layer, rl, :S] = v
    return _last_rows(_final_norm(model, cfg, x), lengths)


@torch.no_grad()
def gr_append_slots(model: GRModel, cfg: ArchConfig, x_new: torch.Tensor,
                    timestamps: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, rows: torch.Tensor,
                    prefix_len: torch.Tensor,
                    n_new: torch.Tensor) -> torch.Tensor:
    """Warm tick over R slot rows (HSTU): only the appended window x_new
    (R, Q, d) of each row is encoded, against the row's cached K/V prefix
    [0, p_r), one append launch of K1-fwd per layer over all R rows.
    ``timestamps`` (R, S) are the rows' full timestamps, the window's
    included; ``prefix_len`` p_r and ``n_new`` n_r (R,) int32 (n_r ≤ Q,
    p_r + Q ≤ S). Each layer's window K/V go into the caches at
    [p_r, p_r + Q). → emb (R, d), the hidden state of each row's last
    appended token: bit for bit what :func:`gr_encode_slots` gives on the
    grown row, and its live K/V likewise."""
    _check_prefix_reuse(cfg)
    cap = k_cache.shape[2]
    ts = timestamps.to(torch.int32)
    if ts.shape[1] < cap:
        ts = torch.cat([ts, ts.new_zeros((ts.shape[0],
                                          cap - ts.shape[1]))], dim=1)
    ts = ts.contiguous()
    rows = rows.to(torch.int32).contiguous()
    prefix_len = prefix_len.to(torch.int32).contiguous()
    total = (prefix_len + n_new.to(torch.int32)).contiguous()
    ninv = attn_ops.position_ninv(cap, x_new.device)
    x = x_new
    for layer, bp in enumerate(model.blocks):
        x = hstu_block_append(bp, cfg, x, ts, k_cache[layer],
                              v_cache[layer], rows, prefix_len, total, ninv)
    return _last_rows(_final_norm(model, cfg, x), n_new)


@torch.no_grad()
def gr_encode_slots_flat(model: GRModel, cfg: ArchConfig, x: torch.Tensor,
                         timestamps: torch.Tensor, lengths: torch.Tensor, *,
                         attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Cold tick without K/V (any block): R slot rows as R packs of one
    row, (R, S, d) → (R, d). The streaming engine's path for FuXi (K1-fwd's
    functional mode, one launch per layer) and SASRec (its inline softmax
    attention), or for HSTU without prefix reuse."""
    h = gr_hidden(model, cfg, x, _row_offsets(lengths), timestamps,
                  attn_fn=attn_fn)
    return _last_rows(h, lengths)


def gr_serve_row_kv(model: GRModel, cfg: ArchConfig, x: torch.Tensor,
                    timestamps: torch.Tensor, length: int):
    """Cold encode of one slot row x (S, d) → (emb (d,), k (L, cap, H, dqk),
    v (L, cap, H, dv)): :func:`gr_encode_slots` on one row, into caches of
    its own."""
    k, v = _row_caches(model, cfg, x)
    lengths = torch.tensor([length], dtype=torch.int32, device=x.device)
    zero = torch.zeros(1, dtype=torch.int32, device=x.device)
    emb = gr_encode_slots(model, cfg, x[None], timestamps[None], lengths,
                          k, v, zero)
    return emb[0], k[:, 0], v[:, 0]


def gr_serve_row_append(model: GRModel, cfg: ArchConfig, x_new: torch.Tensor,
                        timestamps: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, prefix_len: int, n_new: int):
    """Warm encode of one slot row's window x_new (Q, d) against its caches
    (L, cap, H, ·), updated in place → (emb (d,), k_cache, v_cache):
    :func:`gr_append_slots` on one row."""
    dev = x_new.device
    one = lambda n: torch.tensor([n], dtype=torch.int32, device=dev)  # noqa
    emb = gr_append_slots(model, cfg, x_new[None], timestamps[None],
                          k_cache[:, None], v_cache[:, None], one(0),
                          one(prefix_len), one(n_new))
    return emb[0], k_cache, v_cache


def _row_caches(model: GRModel, cfg: ArchConfig, x: torch.Tensor):
    """Zeroed (L, 1, cap, H, dqk) K/V caches for one row."""
    H = cfg.num_heads
    dqk = cfg.qkv_dim or cfg.resolved_head_dim
    shape = (cfg.num_layers, 1, slot_capacity(x.shape[-2]), H, dqk)
    return (torch.zeros(shape, dtype=x.dtype, device=x.device),
            torch.zeros(shape, dtype=x.dtype, device=x.device))
