"""HSTU (paper) — Hierarchical Sequential Transduction Unit variants.

Paper Appendix A: embedding dims 128/256/512/1024 (tiny/small/medium/large),
2/4/8/16 stacked blocks, 8 heads, per-head qkv dims 16/32/64/128, seq len 2000
(long: 4096). RAB = bucketized time (32 buckets) + relative position.
"""
from repro_torch.configs.base import ArchConfig, RABConfig

_RAB = RABConfig(num_pos_buckets=256, num_time_buckets=32)


def _hstu(tag: str, d: int, layers: int, qkv: int, seq: int) -> ArchConfig:
    return ArchConfig(
        name=f"hstu-{tag}",
        family="gr",
        num_layers=layers,
        d_model=d,
        num_heads=8,
        num_kv_heads=8,
        head_dim=qkv,
        d_ff=0,                      # HSTU has no separate FFN (U-gated attn)
        vocab_size=2 ** 22,          # item-ID space (synthetic KuaiRand-27K)
        gr=True,
        gr_block="hstu",
        rab=_RAB,
        qkv_dim=qkv,
        max_seq_len=seq,
        rope_theta=0.0,              # GR models use RAB, not RoPE
        source="arXiv:2409.12740 paper Appendix A; HSTU arXiv:2402.17152",
    )


HSTU_TINY = _hstu("tiny", 128, 2, 16, 2048)
HSTU_SMALL = _hstu("small", 256, 4, 32, 2048)
HSTU_MEDIUM = _hstu("medium", 512, 8, 64, 2048)
HSTU_LARGE = _hstu("large", 1024, 16, 128, 2048)
HSTU_LONG = _hstu("long", 1024, 16, 128, 4096)

CONFIGS = {c.name: c for c in
           (HSTU_TINY, HSTU_SMALL, HSTU_MEDIUM, HSTU_LARGE, HSTU_LONG)}
