"""ArchConfig → the GR model functions the train step binds (the port of
``repro.models.model_zoo.GRBundle``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import negative_sampling as NS
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.neg_logits import TableGradSink
from repro_torch.models import gr as GR

Batch = dict


@dataclass(frozen=True)
class GRBundle:
    cfg: ArchConfig

    def init_dense(self, generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> GR.GRModel:
        """Dense params with ``init_gr``'s distributions; ``device=None``
        means the card."""
        return GR.GRModel(self.cfg, device=device, generator=generator)

    def init_table(self, generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> torch.Tensor:
        """The (V, d) fp32 master, N(0, 0.02²), drawn where it lives."""
        device = resolve_device(device)
        return torch.randn(self.cfg.vocab_size, self.cfg.d_model,
                           dtype=torch.float32, device=device,
                           generator=generator) * 0.02

    def input_gather(self, table: torch.Tensor, batch: Batch
                     ) -> torch.Tensor:
        """The input-side lookup as its own stage (Algorithm 1's emb_fwd):
        a plain gather + cast, exactly the one :meth:`loss` performs."""
        return table[batch["ids"].long()].to(GR.torch_dtype(self.cfg.dtype))

    def loss(self, dense: GR.GRModel, table: torch.Tensor, batch: Batch, *,
             neg_mode: str = "fused", expansion: int = 1,
             neg_segment: int = 128, fetch_dtype=torch.float16,
             neg_scatter_impl: str = "fused",
             perms: Optional[torch.Tensor] = None,
             attn_fn: Optional[Callable] = None,
             x_emb: Optional[torch.Tensor] = None,
             pos_emb: Optional[torch.Tensor] = None,
             shadow: Optional[torch.Tensor] = None,
             table_grad_pairs: Optional[TableGradSink] = None,
             remat: bool = True) -> torch.Tensor:
        """Sampled-softmax recall loss over a sharded jagged batch:
        ids/timestamps/labels (G, cap), offsets (G, S+1), neg_ids
        (G, cap, R), rng (2,).

        ``x_emb``/``pos_emb``: precomputed input and label rows (the train
        step passes them as leaves, so their grads are the sparse table
        contributions); else gathered from ``table``, which then gets a
        dense grad if it requires one (test sizes). ``shadow``: the
        half-precision table the negatives are gathered from.
        ``table_grad_pairs`` (a ``TableGradSink``) receives the negative
        rows' table grad as (ids, rows). ``neg_scatter_impl`` must be
        ``"two_pass"`` until K5 is ported. ``perms``: the §4.3.3 sharing
        shuffle for expansion > 1, else drawn from a generator seeded by
        ``batch["rng"][0]``."""
        cfg = self.cfg
        if neg_mode != "fused":
            raise NotImplementedError(
                f"neg_mode={neg_mode!r}: only the fused path is ported")
        x = self.input_gather(table, batch) if x_emb is None else x_emb
        G, cap = batch["ids"].shape
        h = GR.gr_hidden_sharded(dense, cfg, x, batch["offsets"],
                                 batch["timestamps"], attn_fn=attn_fn,
                                 remat=remat)
        if pos_emb is None:
            pos_emb = table[batch["labels"].long()].to(x.dtype)
        valid = (torch.arange(cap, device=x.device)[None, :]
                 < batch["offsets"][:, -1:])
        R = batch["neg_ids"].shape[-1]
        generator = None
        if expansion > 1 and perms is None:
            generator = torch.Generator(device=x.device).manual_seed(
                int(batch["rng"][0]))
        return NS.fused_sampled_softmax_loss(
            h.reshape(G * cap, -1), pos_emb.reshape(G * cap, -1), table,
            batch["neg_ids"].reshape(G * cap, R), perms=perms,
            generator=generator, tau=1.0, valid=valid.reshape(-1),
            segment=neg_segment, expansion=expansion,
            fetch_dtype=fetch_dtype, shadow=shadow,
            scatter_impl=neg_scatter_impl,
            table_grad_pairs=table_grad_pairs)


def get_bundle(cfg: ArchConfig) -> GRBundle:
    if not cfg.gr:
        raise NotImplementedError(f"{cfg.name}: only GR models are ported")
    return GRBundle(cfg)
