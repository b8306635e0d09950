"""PyTorch/CUDA port of the GR system for NVIDIA Hopper.

A package beside the JAX reference (``src/repro``) with the same
subpackage names. It imports torch and numpy only. Entry points run on the
card unless the caller passes ``device="cpu"``; there, every kernel
wrapper takes its plain PyTorch version.

Ported so far: recall serving (``serving.RecallEngine``), the recall
training step (``training.make_gr_train_step`` over
``models.model_zoo.GRBundle.loss``, sync and τ=1) and the training entry
point (``training.GREngine``, the Algorithm-1 pipeline and the flat
schedule; ``python -m repro_torch.launch.train``) on HSTU, with the
jagged-attention forward and backward, the fused negative-sampling forward
and backward, the weighted run-sum scatter and the sorted run-sum as
hand-written CUDA kernels (``csrc/*.cu``).
"""
