"""FuXi-α GR block: HSTU's pointwise attention with FuXi's functional
(exponential-power) time encoder in place of the bucket time table, and an
explicit feature-interaction FFN branch (the port of ``repro.models.fuxi``).

Parameter accounting (paper Table 1): per layer ≈ 5·d² attention (f1:
d→4d, f2: d→d) + 3·d·d_ff gated FFN with d_ff = round64(7d/3) ≈ 7·d², so
FuXi-large has 16 × 12.6 M ≈ 201.6 M dense parameters.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.hstu import HSTUBlock, _block_norm, _silu, hstu_block


def fuxi_ffn_dim(d_model: int) -> int:
    """d_ff = round-to-64(7·d/3), calibrated to Table 1's counts."""
    return max(64, int(round(7 * d_model / 3 / 64)) * 64)


class FuXiBlock(HSTUBlock):
    """An HSTU block whose RAB holds the functional time encoder's
    ``time_amp`` (0.02), ``time_log_sigma`` (linspace 2 → 12) and
    ``time_rho`` (0), all fp32 (H,), in place of ``time_table``, plus the
    gated FFN: ``ffn_ln_w``/``ffn_ln_b``, ``ffn_w_in`` and ``ffn_w_gate``
    (d, d_ff) and ``ffn_w_out`` (d_ff, d), with ``init_fuxi_block``'s
    scales."""

    def __init__(self, cfg: ArchConfig, *, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, dtype=dtype, device=device, generator=generator)
        H = cfg.num_heads
        if cfg.rab is not None and cfg.rab.use_time:
            del self.rab["time_table"]
            f32 = dict(dtype=torch.float32, device=device)
            self.rab["time_amp"] = nn.Parameter(torch.full((H,), 0.02, **f32))
            self.rab["time_log_sigma"] = nn.Parameter(
                torch.linspace(2.0, 12.0, H, **f32))
            self.rab["time_rho"] = nn.Parameter(torch.zeros(H, **f32))
        d, d_ff = cfg.d_model, cfg.d_ff or fuxi_ffn_dim(cfg.d_model)

        def normal(*shape):
            return torch.randn(*shape, dtype=torch.float32, device=device,
                               generator=generator)

        self.ffn_ln_w = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.ffn_ln_b = nn.Parameter(torch.zeros(d, dtype=dtype,
                                                 device=device))
        self.ffn_w_in = nn.Parameter(
            (normal(d, d_ff) / math.sqrt(d)).to(dtype))
        self.ffn_w_gate = nn.Parameter(
            (normal(d, d_ff) / math.sqrt(d)).to(dtype))
        self.ffn_w_out = nn.Parameter(
            (normal(d_ff, d) / math.sqrt(d_ff * 2 * cfg.num_layers)).to(dtype))


def fuxi_block(p: FuXiBlock, cfg: ArchConfig, x: torch.Tensor,
               offsets: torch.Tensor, timestamps: torch.Tensor, *,
               attn_fn=None, plan=None) -> torch.Tensor:
    """One FuXi block over packed tokens x (cap, d) or (G, cap, d): the
    HSTU block in the functional time mode, then the gated FFN with its
    residual."""
    x = hstu_block(p, cfg, x, offsets, timestamps, attn_fn=attn_fn,
                   time_mode="functional", plan=plan)
    h = _block_norm(x, p.ffn_ln_w, p.ffn_ln_b, cfg.norm_eps)
    ff = (_silu(h @ p.ffn_w_gate) * (h @ p.ffn_w_in)) @ p.ffn_w_out
    return x + ff
