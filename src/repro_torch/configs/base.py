"""Architecture configuration dataclasses (the port's own copy).

Plain frozen dataclasses, field for field the JAX package's
``repro.configs.base``, so a configuration means the same model on both
sides. The port keeps its own copy and imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


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

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
