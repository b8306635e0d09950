"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    use_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,    # Cohere ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
