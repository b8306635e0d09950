"""Config registry: ``get_arch(name)`` / ``ARCHS`` for ``--arch``
selection: the GR models the port serves and trains (HSTU, FuXi-α,
SASRec) and the 10 assigned LM architectures."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import fuxi as _fuxi
from repro_torch.configs import hstu as _hstu
from repro_torch.configs import sasrec as _sasrec
from repro_torch.configs.base import (ArchConfig, MoEConfig, RABConfig,
                                      SSMConfig, count_active_params,
                                      count_params)
from repro_torch.configs.command_r_35b import CONFIG as COMMAND_R_35B
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from repro_torch.configs.glm4_9b import CONFIG as GLM4_9B
from repro_torch.configs.internlm2_20b import CONFIG as INTERNLM2_20B
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN_LARGE
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.shapes import (ALL_SHAPES, DECODE_32K, GR_SHAPES,
                                        LONG_500K, PREFILL_32K,
                                        SHAPES_BY_NAME, TRAIN_4K, ShapeConfig,
                                        cells_for, shape_applicable,
                                        shapes_for)
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2_3B

# The 10 assigned LM architectures.
ASSIGNED: Dict[str, ArchConfig] = {c.name: c for c in (
    PIXTRAL_12B, OLMOE_1B_7B, DEEPSEEK_MOE_16B, STARCODER2_3B, GLM4_9B,
    INTERNLM2_20B, COMMAND_R_35B, JAMBA_1_5_LARGE, MAMBA2_2_7B,
    MUSICGEN_LARGE,
)}

# The paper's own models (+ its SASRec baseline, Appendix A).
GR_CONFIGS: Dict[str, ArchConfig] = {**_hstu.CONFIGS, **_fuxi.CONFIGS,
                                     **_sasrec.CONFIGS}

ARCHS: Dict[str, ArchConfig] = {**ASSIGNED, **GR_CONFIGS}


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


__all__ = ["ALL_SHAPES", "ARCHS", "ASSIGNED", "ArchConfig", "DECODE_32K",
           "GR_CONFIGS", "GR_SHAPES", "LONG_500K", "MoEConfig", "PREFILL_32K",
           "RABConfig", "SHAPES_BY_NAME", "SSMConfig", "ShapeConfig",
           "TRAIN_4K", "cells_for", "count_active_params", "count_params",
           "get_arch", "reduced", "shape_applicable", "shapes_for"]
