"""mamba2-2.7b [ssm] — 64L d_model=2560 attn-free vocab=50280 ssm_state=128,
SSD (state-space duality). [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                 # Mamba-2 blocks have no separate MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4),
    attn_every=0,           # attention-free
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
