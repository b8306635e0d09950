"""Config registry: ``get_arch(name)`` / ``ARCHS`` for the GR models the
port serves (FuXi and SASRec configs arrive with their blocks)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import hstu as _hstu
from repro_torch.configs.base import (ArchConfig, MoEConfig, RABConfig,
                                      SSMConfig)

ARCHS: Dict[str, ArchConfig] = dict(_hstu.CONFIGS)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test-sized config of the same family (CPU-runnable); the same
    cut as the JAX package's ``reduced``."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2 if cfg.attn_every <= 1 else
                       2 * max(cfg.attn_every, 1)),
        d_model=128,
        vocab_size=min(cfg.vocab_size, 512),
        d_ff=256 if cfg.d_ff else 0,
        max_seq_len=min(cfg.max_seq_len, 128),
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 2 if cfg.num_kv_heads < cfg.num_heads else 4
        kw["head_dim"] = 32
    if cfg.moe is not None:
        kw["moe"] = cfg.moe.__class__(
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=64,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            every=cfg.moe.every,
        )
    if cfg.ssm is not None:
        kw["ssm"] = cfg.ssm.__class__(d_state=16, head_dim=16, expand=2,
                                      conv_width=4, chunk=32)
    if cfg.attn_every > 1:
        kw["num_layers"] = 2 * cfg.attn_every
    if cfg.gr:
        kw["qkv_dim"] = 16
        kw["head_dim"] = 16
    return cfg.replace(**kw)


__all__ = ["ArchConfig", "MoEConfig", "RABConfig", "SSMConfig", "ARCHS",
           "get_arch", "reduced"]
