"""GR model = stack of HSTU or FuXi blocks over a packed jagged token
buffer (``cfg.gr_block`` picks the block, as the reference's ``_BLOCKS``).

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
before the layer loop and shared by every layer.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models.fuxi import FuXiBlock, fuxi_block
from repro_torch.models.hstu import HSTUBlock, default_attn_fn, hstu_block

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


#: gr_block → (parameter module, block function)
_BLOCKS = {"hstu": (HSTUBlock, hstu_block), "fuxi": (FuXiBlock, fuxi_block)}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _block(cfg: ArchConfig):
    kind = cfg.gr_block or "hstu"
    if kind not in _BLOCKS:
        raise NotImplementedError(
            f"gr_block={kind!r}: not ported yet (ported: {sorted(_BLOCKS)})")
    return _BLOCKS[kind]


class GRModel(nn.Module):
    """Dense GR parameters: ``blocks`` (one :class:`HSTUBlock` or
    :class:`FuXiBlock` per layer, the JAX pytree's stacked layer axis split
    out) and the final affine norm. Initialised with ``init_gr``'s
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
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
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
