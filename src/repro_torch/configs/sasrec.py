"""SASRec (paper Appendix A baseline) — the same scaling grid as HSTU and
FuXi: embedding dims 128/256/512/1024, 2/4/8/16 blocks, 8 heads, per-head
qkv dims 16/32/64/128, seq 2048. Time-agnostic (no RAB); a pointwise FFN
of width d (Kang & McAuley, ICDM 2018)."""
from repro_torch.configs.base import ArchConfig


def _sasrec(tag: str, d: int, layers: int, qkv: int, seq: int) -> ArchConfig:
    return ArchConfig(
        name=f"sasrec-{tag}",
        family="gr",
        num_layers=layers,
        d_model=d,
        num_heads=8,
        num_kv_heads=8,
        head_dim=qkv,
        d_ff=d,                      # pointwise FFN (original SASRec)
        vocab_size=2 ** 22,
        gr=True,
        gr_block="sasrec",
        rab=None,
        qkv_dim=qkv,
        max_seq_len=seq,
        rope_theta=0.0,
        source="paper Appendix A; SASRec Kang&McAuley 2018 (ICDM)",
    )


SASREC_TINY = _sasrec("tiny", 128, 2, 16, 2048)
SASREC_SMALL = _sasrec("small", 256, 4, 32, 2048)
SASREC_MEDIUM = _sasrec("medium", 512, 8, 64, 2048)
SASREC_LARGE = _sasrec("large", 1024, 16, 128, 2048)

CONFIGS = {c.name: c for c in
           (SASREC_TINY, SASREC_SMALL, SASREC_MEDIUM, SASREC_LARGE)}
