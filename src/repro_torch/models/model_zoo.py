"""ArchConfig → model functions (the port of ``repro.models.model_zoo``).

Two families:
  * LM bundles (the 10 assigned architectures): init / loss / prefill /
    decode over (tokens|embeds, labels) batches, and ``input_specs``.
  * GR bundles (HSTU, FuXi, SASRec: the paper's models): dense init + the
    jagged batch's sampled-softmax recall loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import negative_sampling as NS
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.neg_logits import TableGradSink, share_layout
from repro_torch.models import gr as GR
from repro_torch.models import transformer as TF

Batch = dict

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclass(frozen=True)
class LMBundle:
    cfg: ArchConfig

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> TF.LM:
        """The stack's parameters (:class:`~repro_torch.models.transformer.
        LM`) drawn from ``generator``; ``device=None`` means the card."""
        return TF.LM(self.cfg, device=device, generator=generator)

    def loss(self, model: TF.LM, batch: Batch, *, q_block: int = 1024,
             remat: bool = True) -> torch.Tensor:
        return TF.lm_loss(model, self.cfg, batch, q_block=q_block,
                          remat=remat)

    def prefill(self, model: TF.LM, batch: Batch, *, q_block: int = 1024,
                max_len: Optional[int] = None):
        return TF.lm_prefill(model, self.cfg, batch, q_block=q_block,
                             max_len=max_len)

    def decode(self, model: TF.LM, token, cache, cache_index, *,
               embeds=None):
        return TF.lm_decode_step(model, self.cfg, token, cache, cache_index,
                                 embeds=embeds)

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None) -> TF.DecodeCache:
        return TF.init_cache(self.cfg, batch, max_len, device=device)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Every model input of ``shape`` as a tensor on the ``meta`` device
        (shape and dtype, no memory), where the reference returns
        ``ShapeDtypeStruct`` s: the batch for train and prefill; for decode
        the cache of ``seq_len`` positions, ``cache_index`` and the token
        (and embeds for stub frontends)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        stub = cfg.frontend == "stub_embed"
        dt = GR.torch_dtype(cfg.dtype)
        i32 = torch.int32
        if shape.kind == "train":
            batch: Dict[str, Any] = {"labels": _spec((B, S), i32)}
            if stub:
                batch["embeds"] = _spec((B, S, cfg.d_model), dt)
            else:
                batch["tokens"] = _spec((B, S), i32)
            return {"batch": batch}
        if shape.kind == "prefill":
            batch = ({"embeds": _spec((B, S, cfg.d_model), dt)} if stub
                     else {"tokens": _spec((B, S), i32)})
            return {"batch": batch}
        out: Dict[str, Any] = {"cache": TF.init_cache(cfg, B, S,
                                                      device=META),
                               "cache_index": _spec((), i32),
                               "token": _spec((B, 1), i32)}
        if stub:
            out["embeds"] = _spec((B, 1, cfg.d_model), dt)
        return out

def gr_capacity(shape: ShapeConfig, num_shards: int) -> Tuple[int, int]:
    """(tokens capacity, max samples) per device shard. The load balancer
    (§4.1.3) packs users to a per-shard token budget; the worst case is
    users_per_shard full-length sequences, with 2× sample-count slack for
    token-aware dynamic batch scaling of short sequences."""
    users = max(1, shape.global_batch // num_shards)
    cap = users * shape.seq_len
    return cap, 2 * users


#: The recall loss's negative paths (the §4.3 / Table-7 ablation).
NEG_MODES = ("fused", "baseline", "segmented")

#: The master is drawn in blocks of this many rows, each from a seed of its
#: own (64 MB at d = 1024), so any row range draws alone.
TABLE_DRAW_ROWS = 1 << 14
_BLOCK_SEED_STRIDE = 0x9E3779B97F4A7C15


@dataclass(frozen=True)
class GRBundle:
    cfg: ArchConfig

    def init_dense(self, generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> GR.GRModel:
        """Dense params with ``init_gr``'s distributions; ``device=None``
        means the card."""
        return GR.GRModel(self.cfg, device=device, generator=generator)

    def init_table(self, generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """The (V, d) fp32 master, N(0, 0.02²), drawn where it lives; with
        ``rows=(lo, hi)`` only those rows, the same bits as the whole
        table's (a rank of a sharded table draws its shard alone). One seed
        is drawn from ``generator``; row block k (of
        :data:`TABLE_DRAW_ROWS`) is drawn from a generator seeded by it and
        k."""
        device = resolve_device(device)
        V, d = self.cfg.vocab_size, self.cfg.d_model
        lo, hi = (0, V) if rows is None else (int(rows[0]), int(rows[1]))
        if not 0 <= lo <= hi <= V:
            raise ValueError(f"rows [{lo}, {hi}) of a {V}-row table")
        gdev = generator.device if generator is not None else "cpu"
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=gdev))
        out = torch.empty((hi - lo, d), dtype=torch.float32, device=device)
        B = TABLE_DRAW_ROWS
        for k in range(lo // B, -(-hi // B)):
            a, b = k * B, min((k + 1) * B, V)
            g = torch.Generator(device=device).manual_seed(
                (seed + k * _BLOCK_SEED_STRIDE) % 2 ** 63)
            blk = torch.randn(b - a, d, dtype=torch.float32, device=device,
                              generator=g)
            s, e = max(a, lo), min(b, hi)
            out[s - lo:e - lo] = blk[s - a:e - a]
        return out.mul_(0.02)

    def input_specs(self, shape: ShapeConfig,
                    num_shards: int = 256) -> Dict[str, Any]:
        """The jagged batch of ``shape`` split over ``num_shards`` packs,
        as tensors on the ``meta`` device (the reference's
        ``ShapeDtypeStruct`` s): (G, cap) ids, labels, timestamps, (G,
        samples + 1) offsets, (G, cap, R) negative ids and the (2,) rng,
        cap and samples from :func:`gr_capacity`."""
        cap, max_samples = gr_capacity(shape, num_shards)
        G, i32 = num_shards, torch.int32
        return {"batch": {
            "ids": _spec((G, cap), i32),
            "labels": _spec((G, cap), i32),
            "timestamps": _spec((G, cap), i32),
            "offsets": _spec((G, max_samples + 1), i32),
            "neg_ids": _spec((G, cap, self.cfg.num_negatives), i32),
            "rng": _spec((2,), torch.int64)}}

    def input_gather(self, table: torch.Tensor, batch: Batch, *,
                     lookup_fn: Optional[Callable] = None) -> torch.Tensor:
        """The input-side lookup as its own stage (Algorithm 1's emb_fwd):
        exactly the gather :meth:`loss` performs for ``batch["ids"]``, a
        plain gather + cast or ``lookup_fn(table, ids)``."""
        if lookup_fn is not None:
            return lookup_fn(table, batch["ids"])
        return table[batch["ids"].long()].to(GR.torch_dtype(self.cfg.dtype))

    def loss(self, dense: GR.GRModel, table: torch.Tensor, batch: Batch, *,
             lookup_fn: Optional[Callable] = None,
             neg_mode: str = "fused", expansion: int = 1,
             neg_segment: int = 128, fetch_dtype=torch.float16,
             neg_scatter_impl: Optional[str] = None,
             perms: Optional[torch.Tensor] = None,
             share_draws: Optional[torch.Tensor] = None,
             attn_fn: Optional[Callable] = None,
             x_emb: Optional[torch.Tensor] = None,
             pos_emb: Optional[torch.Tensor] = None,
             shadow: Optional[torch.Tensor] = None,
             table_grad_pairs: Optional[TableGradSink] = None,
             remat: bool = True, hsp=None) -> torch.Tensor:
        """Sampled-softmax recall loss over a sharded jagged batch:
        ids/timestamps/labels (G, cap), offsets (G, S+1), neg_ids
        (G, cap, R), rng (2,).

        ``neg_mode``: "fused" (default) runs the ID-driven kernels (K3/K4):
        gather, dequant, §4.3.3 sharing and Eq.-2 logsumexp in one pass,
        no (T, R, d) or (T, R·k) buffers; "baseline" materialises the
        (G, cap, R, d) negative rows of the master in the model's dtype
        (the Table-7 reference); "segmented" fetches fp16 rows one segment
        of tokens at a time (§4.3.1 + §4.3.2; cap must be a ``neg_segment``
        multiple). Both of the latter take their logits with K9 and share
        them with :func:`~repro_torch.core.negative_sampling.share_logits`
        for ``expansion`` > 1.

        ``lookup_fn(table, ids)``: the input and label lookup (default a
        plain gather + cast; ``kernels.jagged_lookup.jagged_lookup`` is
        K7). ``x_emb``/``pos_emb``: precomputed input and label rows (the
        train step passes them as leaves, so their grads are the sparse
        table contributions); else looked up in ``table``, which then gets
        a dense grad if it requires one (test sizes). ``shadow``: the
        half-precision table the fused path gathers from.
        ``table_grad_pairs`` (a ``TableGradSink``) receives the negative
        rows' table grad as sparse pairs: factored for K5 with
        ``neg_scatter_impl="fused"`` or as rows with ``"two_pass"`` in the
        fused mode (None: the tuned store's choice, ``"fused"`` unless a
        sweep stored another), as rows in the other two.
        ``perms`` (fused) and ``share_draws`` (G, cap, (k−1)·R) (the
        others): the §4.3.3 sharing draws for expansion > 1, else
        ``batch["share_perms"]`` when the batch carries them (fused; the
        global batch's, as :func:`~repro_torch.kernels.neg_logits.
        make_share_perms` shapes them), else drawn from a generator
        seeded by ``batch["rng"][0]``.

        ``hsp`` (a :class:`~repro_torch.core.hsp.HSPLookup`): ``table`` and
        ``shadow`` are this rank's shard and ``batch`` its pack of the
        global batch. The negative rows come through the HSP exchange (a
        compact buffer K3/K4 read), and the loss is this rank's part of the
        global batch's mean (its tokens over the global valid count), so
        the parts of all ranks sum to the global loss. Fused mode only.
        With ``expansion`` > 1 the shared pool is the global batch's, as
        the reference's flattened batch: the packs in rank order, in
        segments of ``neg_segment`` each computed on the rank that holds
        its first token (``HSPLookup.share_tokens``), the global perms
        drawn (or given) on every rank and sliced to its segments."""
        cfg = self.cfg
        if neg_mode not in NEG_MODES:
            raise ValueError(f"neg_mode {neg_mode!r} not in {NEG_MODES}")
        if hsp is not None and neg_mode != "fused":
            raise ValueError(f"the sharded table runs the fused negative "
                             f"path, not {neg_mode!r}")
        if x_emb is None:
            x = self.input_gather(table, batch, lookup_fn=lookup_fn)
        else:
            x = x_emb
        G, cap = batch["ids"].shape
        h = GR.gr_hidden_sharded(dense, cfg, x, batch["offsets"],
                                 batch["timestamps"], attn_fn=attn_fn,
                                 remat=remat)
        if pos_emb is None:
            pos_emb = (lookup_fn(table, batch["labels"]) if lookup_fn
                       else table[batch["labels"].long()].to(x.dtype))
        valid = (torch.arange(cap, device=x.device)[None, :]
                 < batch["offsets"][:, -1:])
        R = batch["neg_ids"].shape[-1]
        T, d = G * cap, h.shape[-1]
        neg_ids = batch["neg_ids"].reshape(T, R)
        generator = None
        if neg_mode == "fused" and perms is None and expansion > 1:
            perms = batch.get("share_perms")
        given = perms if neg_mode == "fused" else share_draws
        if expansion > 1 and given is None:
            generator = torch.Generator(device=x.device).manual_seed(
                int(batch["rng"][0]))
        if hsp is not None:
            o = h.reshape(T, d)
            pos = NS.positive_logits(o, pos_emb.reshape(T, -1))
            v, share, anchor = valid.reshape(-1), None, None
            vt = hsp.valid_total(valid)
            if expansion > 1:
                share = share_layout(hsp.world, hsp.rank, T, neg_segment)
                o, pos, v, neg_ids, anchor = hsp.share_tokens(
                    share, o, pos, v, neg_ids)
            src = table if shadow is None else shadow
            rows, index = hsp.fetch_rows(src, neg_ids)
            if shadow is None and fetch_dtype is not None:
                rows = rows.to(fetch_dtype)     # the fetch's rounding
            loss = NS.fused_recall_loss(
                o, pos, table, neg_ids, perms=perms, generator=generator,
                tau=1.0, valid=v, segment=neg_segment, expansion=expansion,
                shadow=rows, shadow_index=index, vocab=hsp.vocab_of(table),
                valid_total=vt, scatter_impl=neg_scatter_impl,
                table_grad_pairs=table_grad_pairs, share=share)
            return loss if anchor is None else loss + anchor
        if neg_mode == "fused":
            return NS.fused_sampled_softmax_loss(
                h.reshape(T, d), pos_emb.reshape(T, -1), table, neg_ids,
                perms=perms, generator=generator, tau=1.0,
                valid=valid.reshape(-1), segment=neg_segment,
                expansion=expansion, fetch_dtype=fetch_dtype, shadow=shadow,
                scatter_impl=neg_scatter_impl,
                table_grad_pairs=table_grad_pairs)
        sink = table_grad_pairs
        if neg_mode == "baseline":
            neg_emb = table[neg_ids.long()].to(h.dtype)      # (T, R, d)
            hook = None
            if sink is not None:
                hook = lambda dn: sink.ready_rows(          # noqa: E731
                    neg_ids, d, dn.device).copy_(dn.reshape(-1, d))
            logits = NS.neg_logits_baseline(h.reshape(T, d), neg_emb,
                                            on_neg_grad=hook)
        else:
            if cap % neg_segment:
                raise ValueError(f"capacity {cap} is not a multiple of the "
                                 f"segment {neg_segment}")
            logits = NS.neg_logits_segmented(
                h.reshape(T, d), table, neg_ids, segment=neg_segment,
                fetch_dtype=fetch_dtype, table_grad_pairs=sink)
        if expansion > 1:
            per_pack = logits.view(G, cap, R)
            logits = torch.cat([NS.share_logits(
                per_pack[g], expansion, valid[g], generator=generator,
                draws=None if share_draws is None else share_draws[g])
                for g in range(G)])
        return NS.recall_loss(h.reshape(T, d), pos_emb.reshape(T, -1),
                              logits, valid=valid.reshape(-1))


def get_bundle(cfg: ArchConfig):
    return GRBundle(cfg) if cfg.gr else LMBundle(cfg)
