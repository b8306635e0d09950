"""pixtral-12b [vlm] — Pixtral-ViT frontend (STUB) + Mistral-Nemo decoder.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

Per the assignment, [vlm] specifies the transformer BACKBONE only; the vision
frontend is a stub — ``input_specs()`` feeds precomputed patch embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,          # Mistral-Nemo uses head_dim 128 (not d_model/heads)
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000_000.0,
    frontend="stub_embed",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
