"""FuXi-α (paper) — feature-interaction enhanced transformer variants.

Same scaling grid as HSTU (Appendix A) but each block adds an explicit
feature-interaction FFN branch (FuXi-α, arXiv:2502.03036) and functional
(exponential-power) time encoding in the RAB. Dense-parameter targets
(paper Table 1): 0.41M/3.18M/25.22M/201.55M — ~2.4× HSTU at equal width.
d_ff = round64(7d/3) (gated) calibrates the per-layer count to 5d² + 7d² =
12d² → FuXi-large 200.3M vs paper's 201.55M (Δ<1%).
"""
from repro_torch.configs.base import ArchConfig, RABConfig

_RAB = RABConfig(num_pos_buckets=256, num_time_buckets=32)


def _ffn(d: int) -> int:
    return max(64, int(round(7 * d / 3 / 64)) * 64)


def _fuxi(tag: str, d: int, layers: int, qkv: int, seq: int) -> ArchConfig:
    return ArchConfig(
        name=f"fuxi-{tag}",
        family="gr",
        num_layers=layers,
        d_model=d,
        num_heads=8,
        num_kv_heads=8,
        head_dim=qkv,
        d_ff=_ffn(d),                # interaction FFN branch (Table 1 match)
        vocab_size=2 ** 22,
        gr=True,
        gr_block="fuxi",
        rab=_RAB,
        qkv_dim=qkv,
        max_seq_len=seq,
        rope_theta=0.0,
        source="paper Appendix A; FuXi-alpha arXiv:2502.03036",
    )


FUXI_TINY = _fuxi("tiny", 128, 2, 16, 2048)
FUXI_SMALL = _fuxi("small", 256, 4, 32, 2048)
FUXI_MEDIUM = _fuxi("medium", 512, 8, 64, 2048)
FUXI_LARGE = _fuxi("large", 1024, 16, 128, 2048)
FUXI_LONG = _fuxi("long", 1024, 16, 128, 4096)

CONFIGS = {c.name: c for c in
           (FUXI_TINY, FUXI_SMALL, FUXI_MEDIUM, FUXI_LARGE, FUXI_LONG)}
