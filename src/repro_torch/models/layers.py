"""Dense LM building blocks (the port of ``repro.models.layers``): norms,
RoPE, GQA attention and the (gated) MLP.

Parameters live in ``nn.Module`` s named after the reference's pytree
leaves (:class:`Attention`: ``wq``, ``wk``, ``wv``, ``wo``, biases ``bq``,
``bk``, ``bv``, ``bo``; :class:`MLP`: ``w_in``, ``w_out``, ``w_gate``,
``b_in``, ``b_out``), an absent leaf an attribute set to None. The
functions take such a module where the reference takes a params dict.

Products in fp32. Where the reference asks for ``preferred_element_type=
float32`` (the attention scores here, the MoE experts, every SSD product),
the port multiplies through :func:`matmul_f32`, whose every product is
exact and every sum fp32 (a bf16 ``torch.matmul`` would round its output
to bf16). Two bf16 (or fp16) operands on the card go to the tensor cores
with fp32 accumulation and an fp32 output (``torch.bmm(...,
out_dtype=torch.float32)``): a product of two bf16 values is exact in
fp32. Their backward products take the fp32 cotangent and run in fp32,
as every product of an fp32 operand does: both operands widened to fp32
(exact), on FMA. Those must not run on TF32 (10-bit operands):
:func:`matmul_f32` raises if ``torch.backends.cuda.matmul.allow_tf32`` is
on for a card tensor.

Attention is scanned over query blocks (a loop here), each block under a
non-reentrant ``torch.utils.checkpoint`` when training: peak activation
memory O(block × S) instead of O(S²). A block's keys end at its last
query: the keys after it are masked for every query of the block, so they
are not computed (the reference computes them and masks them: its
weights there are exp(−inf) = 0, and the kept ones differ by the sums'
order alone).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sharding import (constrain, is_split,
                                      logical_axis_size, per_shard)


def has(p: nn.Module, name: str) -> bool:
    return getattr(p, name, None) is not None


_HALF = (torch.bfloat16, torch.float16)


class _HalfMatmulF32(torch.autograd.Function):
    """(N, M, K) @ (N, K, P) of two bf16/fp16 card tensors → fp32, on the
    tensor cores with fp32 accumulation; the grads' products (an fp32
    cotangent) in fp32, cast back to the operands' dtypes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with exact products and fp32 sums whatever the operands'
    dtype (the reference's ``preferred_element_type=jnp.float32``): two
    bf16/fp16 card tensors (3-D, the same batch) on the tensor cores with
    an fp32 output; otherwise both widened to fp32 (exact) and multiplied
    in fp32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the LM's fp32 products need torch.backends.cuda.matmul."
            "allow_tf32 = False (TF32 rounds the operands to 10 bits)")
    if (a.is_cuda and a.dtype in _HALF and b.dtype == a.dtype
            and a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]):
        return _HalfMatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def _normal(shape, scale: float, dtype, device, generator) -> nn.Parameter:
    """N(0, scale²) drawn in fp32 from ``generator``, cast to ``dtype``."""
    t = torch.randn(*shape, dtype=torch.float32, device=device,
                    generator=generator)
    return nn.Parameter((t * scale).to(dtype))


def _const(shape, fill: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device))


def dense_init(d_in: int, d_out: int, dtype, device, generator,
               scale: Optional[float] = None) -> nn.Parameter:
    return _normal((d_in, d_out), 1.0 / math.sqrt(d_in) if scale is None
                   else scale, dtype, device, generator)


def embed_init(vocab: int, d: int, dtype, device,
               generator) -> nn.Parameter:
    return _normal((vocab, d), 0.02, dtype, device, generator)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S). Rotates the
    two halves of the head dimension (x1 = x[..., :hd/2], x2 = the rest),
    not interleaved pairs, as the reference does."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    # the halves joined along hd itself: over a mesh no new dim appears
    # that DTensor could split (torch 2.11 splits a stacked dim of 2)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA attention's parameters (``init_attention``'s scales): ``wq``
    (d, H·hd), ``wk``/``wv`` (d, Hkv·hd), ``wo`` (H·hd, d) at
    1/√(H·hd·2·L); zero biases with ``use_qkv_bias`` or ``use_bias``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device, generator=None):
        super().__init__()
        hd = cfg.resolved_head_dim
        d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        self.wq = dense_init(d, H * hd, dtype, device, generator)
        self.wk = dense_init(d, Hkv * hd, dtype, device, generator)
        self.wv = dense_init(d, Hkv * hd, dtype, device, generator)
        self.wo = dense_init(H * hd, d, dtype, device, generator,
                             scale=1.0 / math.sqrt(H * hd * 2
                                                   * cfg.num_layers))
        self.bq = self.bk = self.bv = self.bo = None
        if cfg.use_qkv_bias or cfg.use_bias:
            self.bq = _const((H * hd,), 0.0, dtype, device)
            self.bk = _const((Hkv * hd,), 0.0, dtype, device)
            self.bv = _const((Hkv * hd,), 0.0, dtype, device)
        if cfg.use_bias:
            self.bo = _const((d,), 0.0, dtype, device)


def whole_sequence(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) with its sequence whole on each device before a
    projection (Megatron-SP's gather; a no-op off a mesh): a matmul
    flattens (B, S), which DTensor refuses while both are split."""
    return constrain(x, "batch", None, None)


def _qkv(p: Attention, cfg: ArchConfig, x: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    x = whole_sequence(x)
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if has(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    # TP strategy: shard attention over q heads when Hq divides the tp
    # axis; otherwise (the reference's context parallelism) the heads and
    # the sequence stay whole on each device of the tp group: a split
    # sequence would have to be flattened with the heads, which DTensor
    # refuses (a declared divergence)
    tp = logical_axis_size("tp")
    heads_ok = tp > 1 and cfg.num_heads % tp == 0
    # the projections' layout before the head split: whole heads over tp
    feat_ax = "tp" if heads_ok else None
    q = constrain(q, "batch", None, feat_ax)
    if heads_ok and cfg.num_kv_heads % tp:
        feat_ax = None                   # too few KV heads: k, v whole
    k, v = (constrain(t, "batch", None, feat_ax) for t in (k, v))
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    head_ax = "tp" if heads_ok else None
    q = constrain(q, "batch", None, head_ax, None)
    k = constrain(k, "batch", None, head_ax, None)
    v = constrain(v, "batch", None, head_ax, None)
    return q, k, v


def gqa_scores_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: int, block: int,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Causal GQA attention over query blocks.

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd). ``q_offset`` is the absolute
    position of q[:, 0] (causal masking against a cache prefix);
    ``lengths`` (B,) masks out key padding. The reference's block rule:
    ``block`` is cut to Sq, and an Sq it does not divide is one block. The
    scores are fp32 products (:func:`matmul_f32`), scaled by 1/√hd; the
    weights are cast to v's dtype before the weighted sum, as the
    reference's. With grad enabled each block runs under a non-reentrant
    checkpoint (the reference's ``nothing_saveable`` per block): its
    backward recomputes the scores instead of keeping the fp32
    probabilities."""
    Hq, Hkv = q.shape[2], k.shape[2]
    tp = logical_axis_size("tp")
    if tp > 1 and Hq % tp == 0 and Hkv % tp:
        # the q heads split over tp, too few KV heads to split: the group
        # reshape below would cut the split heads dim, so each q head gets
        # its KV head's copy (the same products, a group of one)
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    # the scores' layout: batch over its axes, KV heads over tp when they
    # split (DTensor may otherwise leave them partial sums, which the
    # in-place mask cannot take)
    s_heads = "tp" if tp > 1 and k.shape[2] % tp == 0 else None
    if is_split(k, 1):
        # the keys' sequence over the mesh (a cache the plan splits by
        # position): the softmax spans devices, DTensor lays it out. The
        # head-major reshapes must not flatten two split dims: with the
        # samples split, q's heads and the scores' stay whole
        if is_split(q, 0):
            q = constrain(q, "batch", None, None, None)
            s_heads = None
        return _gqa_blocked(q, k, v, lengths, q_offset=q_offset,
                            block=block, s_heads=s_heads)
    core = functools.partial(_gqa_blocked, q_offset=q_offset, block=block,
                             s_heads=None)
    # samples and heads are independent: each device runs its shard
    heads = ("batch", None, "tp" if tp > 1 and Hq % tp == 0 else None, None)
    return per_shard(core, (q, k, v, lengths), (heads, heads, heads,
                                                ("batch",)), heads)


def _gqa_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None, *, q_offset: int,
                 block: int, s_heads: Optional[str]) -> torch.Tensor:
    """:func:`gqa_scores_blocked`'s work, its KV heads dividing the q
    heads' split; the scores' KV heads laid out over ``s_heads``."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    s_dims = ("batch", s_heads)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    kpos = torch.arange(Sk, dtype=torch.int32, device=dev)
    kv_valid = (kpos[None, :] < lengths[:, None]) if lengths is not None \
        else None
    # head-major keys and values, (B·Hkv, Sk, hd), copied once per call
    kh = k.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, hd)
    vh = v.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, hd)

    block = min(block, Sq)
    if Sq % block:          # non-divisible (odd prefill lengths): one block
        block = Sq
    nb = Sq // block

    def one_block(qb: torch.Tensor, q0: int) -> torch.Tensor:
        # qb: (B, blk, Hkv, g, hd), absolute positions q0 .. q0 + blk
        blk = qb.shape[1]
        kend = max(1, min(Sk, q0 + blk))     # later keys: masked for all
        qh = qb.permute(0, 2, 3, 1, 4).reshape(B * Hkv, g * blk, hd)
        s = matmul_f32(qh, kh[:, :kend].transpose(1, 2)) * scale
        s = constrain(s.view(B, Hkv, g, blk, kend), *s_dims)
        qpos = torch.arange(q0, q0 + blk, dtype=torch.int32, device=dev)
        if kv_valid is not None:
            mask = qpos[:, None] >= kpos[None, :kend]          # causal
            mask = (mask[None] & kv_valid[:, None, :kend])[:, None, None]
            s = s.masked_fill(~mask, float("-inf"))
        elif q0 < kend:
            # keys before q0 are seen by every query of the block: only
            # the block's diagonal keys [q0, kend) are masked (in place)
            tri = qpos[:, None] < kpos[None, q0:kend]
            s[..., q0:kend].masked_fill_(tri, float("-inf"))
        w = torch.softmax(s, dim=-1)
        if kv_valid is not None:
            # a row with every key masked (length 0) → zeros, not NaN;
            # without lengths the causal mask keeps key 0 for every row
            w = torch.where(torch.isnan(w), 0.0, w)
        w = w.to(v.dtype).view(B * Hkv, g * blk, kend)
        out = torch.bmm(w, vh[:, :kend]).view(B, Hkv, g, blk, hd)
        return out.permute(0, 3, 1, 2, 4)                # (B, blk, Hkv, g, hd)

    remat = torch.is_grad_enabled()
    qs = q.reshape(B, Sq, Hkv, g, hd)
    outs = []
    for i in range(nb):
        qb = qs[:, i * block:(i + 1) * block]
        q0 = q_offset + i * block
        outs.append(checkpoint(one_block, qb, q0, use_reentrant=False)
                    if remat else one_block(qb, q0))
    out = outs[0] if nb == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, Hq, hd)


def attention(p: Attention, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *,
              lengths: Optional[torch.Tensor] = None, q_block: int = 1024,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_index: Optional[int] = None):
    """Full attention layer. Returns (out, kv_cache).

    Train/prefill without a cache: causal self-attention over x. With
    ``kv_cache=(K, V)`` of shape (B, Smax, Hkv, hd): x's K and V are
    written into the cache at ``cache_index`` in place (no copy of the
    cache), and the queries attend over the cache's first ``cache_index +
    S`` positions (the reference masks the rest with ``lengths``; here
    they are sliced off: the same weights, none of the reads)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, cfg, x)
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    tp = logical_axis_size("tp")
    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        i = int(cache_index)
        with torch.no_grad():
            ck[:, i:i + S] = k.to(ck.dtype)
            cv[:, i:i + S] = v.to(cv.dtype)
        new_cache = (ck, cv)
        klen = i + S
        out = gqa_scores_blocked(q, ck[:, :klen], cv[:, :klen], i, q_block)
    else:
        out = gqa_scores_blocked(q, k, v, 0, q_block, lengths=lengths)

    head_ax = "tp" if tp > 1 and cfg.num_heads % tp == 0 else None
    out = constrain(out, "batch", None, head_ax, None)
    out = constrain(out.reshape(B, S, cfg.num_heads * hd), "batch", None,
                    head_ax) @ p.wo
    if has(p, "bo"):
        out = out + p.bo
    return out, new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": _gelu, "relu": F.relu}


class MLP(nn.Module):
    """``init_mlp``'s parameters: ``w_in`` (d, d_ff), ``w_out`` (d_ff, d) at
    1/√(d_ff·2·L), ``w_gate`` with ``glu``, zero ``b_in``/``b_out`` with
    ``use_bias``."""

    def __init__(self, cfg: ArchConfig, d_ff: int, *, dtype, device,
                 generator=None):
        super().__init__()
        d = cfg.d_model
        self.w_in = dense_init(d, d_ff, dtype, device, generator)
        self.w_out = dense_init(d_ff, d, dtype, device, generator,
                                scale=1.0 / math.sqrt(d_ff * 2
                                                      * cfg.num_layers))
        self.w_gate = (dense_init(d, d_ff, dtype, device, generator)
                       if cfg.glu else None)
        self.b_in = self.b_out = None
        if cfg.use_bias:
            self.b_in = _const((d_ff,), 0.0, dtype, device)
            self.b_out = _const((d,), 0.0, dtype, device)


def mlp(p: MLP, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    act = _ACTS[cfg.act]
    x = whole_sequence(x)
    h = x @ p.w_in
    if has(p, "b_in"):
        h = h + p.b_in
    if has(p, "w_gate"):
        h = act(x @ p.w_gate) * h
    else:
        h = act(h)
    h = constrain(h, "batch", None, "tp")
    out = h @ p.w_out
    if has(p, "b_out"):
        out = out + p.b_out
    return out
