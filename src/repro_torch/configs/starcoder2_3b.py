"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, GQA + RoPE. [arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    use_bias=True,          # StarCoder2 uses bias terms
    use_qkv_bias=True,
    glu=False,              # plain GELU MLP (not gated)
    act="gelu",
    rope_theta=100_000.0,
    tie_embeddings=True,
    source="arXiv:2402.19173; hf",
)
