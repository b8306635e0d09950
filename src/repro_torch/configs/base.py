"""Architecture configuration dataclasses (the port's own copy).

Plain frozen dataclasses, field for field the JAX package's
``repro.configs.base``, so a configuration means the same model on both
sides. The port keeps its own copy and imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 0
    d_expert: int = 0               # per-expert hidden dim
    num_shared_experts: int = 0     # DeepSeek-style always-on experts
    every: int = 1                  # MoE layer every `every` layers
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128              # N
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256                # SSD chunk length
    n_groups: int = 1               # B/C groups


@dataclass(frozen=True)
class RABConfig:
    """Relative attention bias (HSTU/FuXi): position + bucketized time."""
    num_pos_buckets: int = 256
    num_time_buckets: int = 32
    time_bucket_scale: float = 0.301  # log10(2) — power-of-2ish bucketing
    use_time: bool = True
    use_pos: bool = True


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio|gr
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1
    norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    use_bias: bool = False
    use_qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"
    glu: bool = True
    frontend: str = "token"
    # --- GR (paper) specifics ----------------------------------------------
    gr: bool = False                # HSTU/FuXi jagged GR model
    gr_block: str = ""              # hstu | fuxi | sasrec
    rab: Optional[RABConfig] = None
    qkv_dim: int = 0                # GR per-head qkv dim (paper Appendix A)
    num_negatives: int = 128
    max_seq_len: int = 8192
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def attention_free(self) -> bool:
        return self.attn_every == 0

    @property
    def hybrid(self) -> bool:
        return self.ssm is not None and self.attn_every > 1

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'ssm'."""
        kinds = []
        for i in range(self.num_layers):
            if self.ssm is None:
                kinds.append("attn")
            elif self.attn_every == 0:
                kinds.append("ssm")
            else:
                # Jamba-style: 1 attention layer per `attn_every` block, in
                # the middle of the period (Jamba puts attn at index 4 of 8)
                kinds.append("attn" if i % self.attn_every == self.attn_every // 2
                             else "ssm")
        return tuple(kinds)

    def moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.every) == (self.moe.every - 1)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def count_params(cfg: ArchConfig) -> int:
    """Analytic parameter count (embedding + dense backbone), for MFU math."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n = cfg.vocab_size * d
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d
    for i, kind in enumerate(cfg.layer_kinds()):
        n += 2 * d  # norms
        if kind == "attn":
            q = cfg.num_heads * hd
            kv = cfg.num_kv_heads * hd
            n += d * (q + 2 * kv) + q * d
        else:
            s = cfg.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # in_proj (z, x, B, C, dt) + out_proj + conv + A, D
            n += d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
            n += d_in * d
            n += s.conv_width * (d_in + 2 * s.n_groups * s.d_state)
            n += 2 * nheads
        if cfg.moe_layer(i):
            m = cfg.moe
            per = 3 * d * m.d_expert if cfg.glu else 2 * d * m.d_expert
            n += m.num_experts * per + m.num_shared_experts * per
            n += d * m.num_experts  # router
        elif cfg.d_ff:
            n += (3 if cfg.glu else 2) * d * cfg.d_ff
    return n + d  # final norm


def count_active_params(cfg: ArchConfig) -> int:
    """Active (per-token) params: MoE counts only top_k + shared experts."""
    if cfg.moe is None:
        return count_params(cfg)
    m = cfg.moe
    per = (3 if cfg.glu else 2) * cfg.d_model * m.d_expert
    n_moe_layers = sum(cfg.moe_layer(i) for i in range(cfg.num_layers))
    return count_params(cfg) - n_moe_layers * (m.num_experts - m.top_k) * per
