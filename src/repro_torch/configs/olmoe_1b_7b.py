"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8. [arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,                 # every layer is MoE
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024, every=1),
    rope_theta=10_000.0,
    source="arXiv:2409.02060; hf",
)
