"""Generic decoder stack for the 10 assigned LM architectures (the port of
``repro.models.transformer``).

Layers repeat with a minimal *period* (dense: 1 layer; jamba: 8 layers,
1 attention + 7 Mamba, MoE every 2). The reference stacks each period
slot's parameters over the periods on a leading axis and scans; here
:class:`LM` holds one :class:`LMLayer` per layer, layer i being slot
i % p of period i // p (``convert.lm_params_from_numpy`` maps the stacked
leaves to their layers), and the forward loops over the layers.

Entry points, as the reference's:
  * :func:`lm_loss` — train: causal-LM loss over (tokens|embeds, labels)
  * :func:`lm_prefill` — prefill: a full forward that fills the cache
  * :func:`lm_decode_step` — decode: one token against the cache

Remat: each period runs under a non-reentrant ``torch.utils.checkpoint``
(the reference's ``nothing_saveable`` per period), and inside it each
attention query block (``layers.gqa_scores_blocked``). Training a full
width model on long sequences fits only with both.

The decode cache (:class:`DecodeCache`) is per layer, and attention writes
a step's K and V into it in place: a functional copy of the cache per
layer per token would move the whole cache (2 × 16 GB a token at
``starcoder2-3b``, batch 16, 32768 positions).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as E
from repro_torch.models.gr import torch_dtype


# --------------------------------------------------------------------------
# period structure
# --------------------------------------------------------------------------

def layer_signature(cfg: ArchConfig, i: int) -> Tuple[str, bool]:
    return (cfg.layer_kinds()[i], cfg.moe_layer(i))


def period_len(cfg: ArchConfig) -> int:
    """Smallest p such that layer signatures repeat with period p."""
    sigs = [layer_signature(cfg, i) for i in range(cfg.num_layers)]
    for p in range(1, cfg.num_layers + 1):
        if cfg.num_layers % p:
            continue
        if all(sigs[i] == sigs[i % p] for i in range(cfg.num_layers)):
            return p
    return cfg.num_layers


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class LMLayer(nn.Module):
    """One layer: ``norm1_w`` and ``attn`` (:class:`~repro_torch.models.
    layers.Attention`) or ``ssm`` (:class:`~repro_torch.models.mamba.
    Mamba`); then ``norm2_w`` and ``moe`` or ``mlp`` if the layer has an
    FFN. ``signature`` is (kind, is_moe), its period slot's."""

    def __init__(self, cfg: ArchConfig, sig: Tuple[str, bool], *, dtype,
                 device, generator=None):
        super().__init__()
        kind, is_moe = sig
        self.signature = sig
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1_w = L._const((cfg.d_model,), 1.0, dtype, device)
        self.attn = L.Attention(cfg, **kw) if kind == "attn" else None
        self.ssm = M.Mamba(cfg, **kw) if kind != "attn" else None
        self.norm2_w = self.moe = self.mlp = None
        if is_moe or cfg.d_ff:
            self.norm2_w = L._const((cfg.d_model,), 1.0, dtype, device)
        if is_moe:
            self.moe = E.MoE(cfg, **kw)
        elif cfg.d_ff:
            self.mlp = L.MLP(cfg, cfg.d_ff, **kw)


class LM(nn.Module):
    """The stack's parameters: ``embed`` (V, d) at 0.02, ``final_norm_w``,
    ``lm_head`` (d, V) at 1/√d unless the embeddings are tied, and
    ``layers``. Drawn from ``generator`` with ``init_lm``'s scales (not its
    draws: the port has its own RNG); ``device=None`` means the card."""

    def __init__(self, cfg: ArchConfig, *, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.gr:
            raise ValueError(f"{cfg.name} is a GR model (GRBundle)")
        device = resolve_device(device)
        dtype = dtype or torch_dtype(cfg.dtype)
        self.cfg = cfg
        p = period_len(cfg)
        self.embed = L.embed_init(cfg.vocab_size, cfg.d_model, dtype, device,
                                  generator)
        self.final_norm_w = L._const((cfg.d_model,), 1.0, dtype, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        L.dense_init(cfg.d_model, cfg.vocab_size, dtype,
                                     device, generator))
        self.layers = nn.ModuleList(
            LMLayer(cfg, layer_signature(cfg, i % p), dtype=dtype,
                    device=device, generator=generator)
            for i in range(cfg.num_layers))


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _attn_block(lp: LMLayer, cfg: ArchConfig, x, positions, lengths,
                q_block: int, cache=None, cache_index=None):
    h = L.rmsnorm(x, lp.norm1_w, cfg.norm_eps)
    h = constrain(h, "batch", "act_sp", None)
    out, new_cache = L.attention(lp.attn, cfg, h, positions,
                                 lengths=lengths, q_block=q_block,
                                 kv_cache=cache, cache_index=cache_index)
    out = constrain(out, "batch", "act_sp", None)
    return x + out, new_cache


def _ssm_block(lp: LMLayer, cfg: ArchConfig, x, seg, state=None):
    h = L.rmsnorm(x, lp.norm1_w, cfg.norm_eps)
    h = constrain(h, "batch", "act_sp", None)
    out, new_state = M.mamba_block(lp.ssm, cfg, h, seg=seg, state=state)
    out = constrain(out, "batch", "act_sp", None)
    return x + out, new_state


def _ffn_block(lp: LMLayer, cfg: ArchConfig, x):
    """Returns (x, aux_loss)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if lp.moe is not None:
        h = L.rmsnorm(x, lp.norm2_w, cfg.norm_eps)
        out, aux = E.moe_apply(lp.moe, cfg, h)
        out = constrain(out, "batch", "act_sp", None)
        return x + out, aux
    if lp.mlp is not None:
        h = L.rmsnorm(x, lp.norm2_w, cfg.norm_eps)
        h = constrain(h, "batch", "act_sp", None)
        out = L.mlp(lp.mlp, cfg, h)
        out = constrain(out, "batch", "act_sp", None)
        return x + out, zero
    return x, zero


# --------------------------------------------------------------------------
# decode cache
# --------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Per-layer caches (the reference stacks them per period slot):
    ``kv[i]`` = (K, V) of attention layer i, each (B, Smax, Hkv, hd);
    ``ssm[i]`` = {"ssm": (B, H, P, N) fp32, "conv": (B, K−1, C)} of Mamba
    layer i."""
    kv: Dict[int, Tuple[torch.Tensor, torch.Tensor]]
    ssm: Dict[int, Dict[str, torch.Tensor]]


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> DecodeCache:
    dtype = dtype or torch_dtype(cfg.dtype)
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    kv: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    ssm: Dict[int, Dict[str, torch.Tensor]] = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "attn":
            shp = (batch, max_len, cfg.num_kv_heads, hd)
            kv[i] = (torch.zeros(shp, dtype=dtype, device=device),
                     torch.zeros(shp, dtype=dtype, device=device))
        else:
            ssm[i] = M.init_mamba_state(cfg, batch, dtype, device=device)
    return DecodeCache(kv=kv, ssm=ssm)


# --------------------------------------------------------------------------
# forward core
# --------------------------------------------------------------------------

def _layer(lp: LMLayer, cfg: ArchConfig, i: int, x, positions, lengths,
           seg, q_block, cache: Optional[DecodeCache] = None,
           cache_index=None):
    """One layer; with ``cache``, its entry for layer i is updated."""
    if lp.attn is not None:
        c = cache.kv.get(i) if cache is not None else None
        x2, nc = _attn_block(lp, cfg, x, positions, lengths, q_block,
                             cache=c, cache_index=cache_index)
        if cache is not None:
            cache.kv[i] = nc
    else:
        st = cache.ssm.get(i) if cache is not None else None
        x2, nc = _ssm_block(lp, cfg, x, seg, state=st)
        if cache is not None:
            cache.ssm[i] = nc
    x2, a = _ffn_block(lp, cfg, x2)
    return constrain(x2, "batch", "act_sp", None), a


def lm_hidden(model: LM, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, lengths=None, seg=None,
              q_block: int = 1024, remat: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack forward (no cache). x: (B, S, d). Returns (hidden, aux loss);
    aux is summed per period, then over periods, as the reference's scan.
    With ``remat`` and grad enabled each period runs under a non-reentrant
    checkpoint."""
    p = period_len(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for per in range(cfg.num_layers // p):
        def period(x_, per=per):
            a = torch.zeros((), dtype=torch.float32, device=x_.device)
            for i in range(per * p, (per + 1) * p):
                x_, a_s = _layer(model.layers[i], cfg, i, x_, positions,
                                 lengths, seg, q_block)
                a = a + a_s
            return x_, a
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(period, x, use_reentrant=False)
        else:
            x, a = period(x)
        aux = aux + a
    x = L.rmsnorm(x, model.final_norm_w, cfg.norm_eps)
    return constrain(x, "batch", "act_sp", None), aux


def _embed_tokens(model: LM, cfg: ArchConfig, tokens: torch.Tensor):
    emb = constrain(model.embed, "vocab", None)
    x = torch.nn.functional.embedding(tokens.long(), emb)
    return constrain(_reduced(x), "batch", "act_sp", None)


def _reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (a lookup into a vocab-sharded table gives
    each rank its own rows' part) reduced first: DTensor's direct
    masked-partial to shard step fails on a batch-sharded lookup. A plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def _inputs(model: LM, cfg: ArchConfig, batch):
    if cfg.frontend == "stub_embed":
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
        return constrain(x, "batch", "act_sp", None)
    return _embed_tokens(model, cfg, batch["tokens"])


def lm_logits(model: LM, cfg: ArchConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    head = model.embed.t() if cfg.tie_embeddings else model.lm_head
    head = constrain(head, None, "vocab")
    return constrain(L.whole_sequence(hidden) @ head, "batch", None, "vocab")


# --------------------------------------------------------------------------
# losses / steps
# --------------------------------------------------------------------------

def _vocab_sharded(x: torch.Tensor) -> bool:
    """Is ``x`` a DTensor split along its last dim?"""
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim in (-1, x.dim() - 1)
        for p in x.placements)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions. The reference contracts the fp32
    logits with a one-hot of the labels (which stays vocab-sharded under
    SPMD); a gather gives the same value, the row's one nonzero term, and
    builds no one-hot (0.8 GB of fp32 a sequence at ``starcoder2-3b``).
    Labels must lie in [0, V) (the one-hot would give an out-of-range
    label a target logit of 0).

    Over a vocab-sharded DTensor (a plan's ``vocab`` axis) a gather along
    the sharded dim has no sharding rule: there the target logit is the
    reference's contraction, the row's one nonzero term selected by a mask
    and summed (the same value: the other terms are zeros), which stays
    sharded and reduces over the vocab axis."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if _vocab_sharded(logits):
        hit = (torch.arange(logits.shape[-1], device=logits.device)
               == labels.long()[..., None])
        tgt = torch.where(hit, logits, 0.0).sum(-1)
    else:
        tgt = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    nll = lse - tgt
    if valid is not None:
        nll = nll * valid
        return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1.0)
    return torch.mean(nll)


def lm_loss(model: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            q_block: int = 1024, remat: bool = True) -> torch.Tensor:
    """Causal-LM loss. batch: {tokens|embeds, labels[, lengths]}."""
    x = _inputs(model, cfg, batch)
    B, S = x.shape[:2]
    dev = x.device
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None, :] \
        .repeat(B, 1)
    lengths = batch.get("lengths")
    hidden, aux = lm_hidden(model, cfg, x, positions, lengths=lengths,
                            q_block=q_block, remat=remat)
    logits = lm_logits(model, cfg, hidden)
    valid = None
    if lengths is not None:
        valid = (torch.arange(S, device=dev)[None, :]
                 < lengths[:, None]).float()
    loss = softmax_xent(logits, batch["labels"], valid)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_coef * aux
    return loss


def lm_loss_microbatched(model: LM, cfg: ArchConfig,
                         batch: Dict[str, torch.Tensor],
                         num_microbatches: int, *, q_block: int = 1024,
                         remat: bool = True) -> torch.Tensor:
    """Loss averaged over microbatches (rows [i·mb, (i+1)·mb) each), summed
    in order in fp32."""
    if num_microbatches <= 1:
        return lm_loss(model, cfg, batch, q_block=q_block, remat=remat)
    B = next(iter(batch.values())).shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} is not a multiple of "
                         f"{num_microbatches} microbatches")
    mb = B // num_microbatches
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(batch.values())).device)
    for i in range(num_microbatches):
        mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        total = total + lm_loss(model, cfg, mbatch, q_block=q_block,
                                remat=remat)
    return total / num_microbatches


#: The logical layout of a decode cache's entries under a mesh (the
#: reference's ``cache_specs``): K/V (B, S, Hkv, hd), the SSM state
#: (B, H, P, N), the conv state (B, K-1, C).
CACHE_AXES = {"kv": ("batch", "cache_seq", "tp", None),
              "ssm": ("batch", "tp", None, None),
              "conv": ("batch", None, "tp")}


def _laid_out(cache: DecodeCache, x: torch.Tensor) -> DecodeCache:
    """The cache a prefill fills, as DTensors in :data:`CACHE_AXES`' layout
    when x is a DTensor (under a shard context); as it is otherwise."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.core.sharding import current_ctx
    ctx = current_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return cache

    def lay(t, dims):
        return distribute_tensor(t, ctx.mesh, ctx.placements(t.shape, dims))
    for i, kv in cache.kv.items():
        cache.kv[i] = tuple(lay(t, CACHE_AXES["kv"]) for t in kv)
    for st in cache.ssm.values():
        for key in st:
            st[key] = lay(st[key], CACHE_AXES[key])
    return cache


@torch.no_grad()
def lm_prefill(model: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               *, q_block: int = 1024, max_len: Optional[int] = None
               ) -> Tuple[torch.Tensor, DecodeCache]:
    """Prefill: a full forward filling a decode cache of ``max_len``
    positions (default: the prompt's); returns the last position's logits
    (B, 1, V) and the cache."""
    x = _inputs(model, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :] \
        .repeat(B, 1)
    lengths = batch.get("lengths")
    cache = _laid_out(init_cache(cfg, B, max_len or S, device=x.device), x)
    for i, lp in enumerate(model.layers):
        x, _ = _layer(lp, cfg, i, x, positions, lengths, None, q_block,
                      cache=cache, cache_index=0)
    x = L.rmsnorm(x, model.final_norm_w, cfg.norm_eps)
    return lm_logits(model, cfg, x[:, -1:, :]), cache


@torch.no_grad()
def lm_decode_step(model: LM, cfg: ArchConfig, token: Optional[torch.Tensor],
                   cache: DecodeCache, cache_index: int, *,
                   embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, DecodeCache]:
    """One decode step at position ``cache_index``. token: (B, 1) (or
    embeds (B, 1, d) for stub frontends). Returns (logits (B, 1, V), the
    cache, updated in place)."""
    batch = {"tokens": token, "embeds": embeds}
    x = _inputs(model, cfg, batch)
    B = x.shape[0]
    i0 = int(cache_index)
    positions = torch.full((B, 1), i0, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(model.layers):
        x, _ = _layer(lp, cfg, i, x, positions, None, None, 1, cache=cache,
                      cache_index=i0)
    x = L.rmsnorm(x, model.final_norm_w, cfg.norm_eps)
    return lm_logits(model, cfg, x), cache
