"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048,
decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Per the assignment, [audio] specifies the transformer BACKBONE only; the
EnCodec frontend is a stub — ``input_specs()`` feeds precomputed frame
embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    glu=False,              # MusicGen uses plain GELU FFN
    act="gelu",
    frontend="stub_embed",
    source="arXiv:2306.05284; hf",
)
