"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]

Layer pattern: one attention layer per 8 (attn_every=8, placed mid-period as
in Jamba), MoE every 2 layers. SSM layers use our Mamba-2 SSD implementation
(DESIGN.md §8 notes this substitution for Jamba's Mamba-1).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,             # dense layers' FFN; MoE layers use d_expert below
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576, every=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4),
    attn_every=8,           # 1 attention : 7 mamba
    rope_theta=10_000.0,
    source="arXiv:2403.19887; hf",
)
