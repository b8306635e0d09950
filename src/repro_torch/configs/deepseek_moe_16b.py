"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared (fine-grained).
[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,                 # assignment specifies the MoE expert dim only;
                            # all layers MoE w/ 2 shared + 64 routed top-6
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2, every=1),
    rope_theta=10_000.0,
    source="arXiv:2401.06066; hf",
)
