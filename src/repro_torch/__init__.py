"""PyTorch/CUDA port of the GR system for NVIDIA Hopper.

A package beside the JAX reference (``src/repro``) with the same
subpackage names. It imports torch and numpy only. Entry points run on the
card unless the caller passes ``device="cpu"``; there, every kernel
wrapper takes its plain PyTorch version.

Ported so far: recall serving (``serving.RecallEngine``) on HSTU, with the
jagged-attention forward as a hand-written CUDA kernel
(``csrc/jagged_attn_fwd.cu``).
"""
