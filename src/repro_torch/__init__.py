"""PyTorch/CUDA port of the GR system for NVIDIA Hopper.

A package beside the JAX reference (``src/repro``) with the same
subpackage names. It imports torch and numpy only. Entry points run on the
card unless the caller passes ``device="cpu"``; there, every kernel
wrapper takes its plain PyTorch version.

Ported so far: recall serving (``serving.RecallEngine``) and the recall
training step (``training.make_gr_train_step`` over
``models.model_zoo.GRBundle.loss``, sync and τ=1) on HSTU, with the
jagged-attention forward and backward, the fused negative-sampling forward
and backward and the sorted run-sum as hand-written CUDA kernels
(``csrc/*.cu``).
"""
