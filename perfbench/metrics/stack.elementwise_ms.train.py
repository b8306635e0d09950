"""stack.elementwise_ms.train: device milliseconds a step in PyTorch's
own elementwise, reduction, copy and indexing kernels (``at::native``),
from the profiled steady steps; the device sort's radix kernels are left
out (they belong to the sparse grads). These kernels run both the GR
stack's norms and activations and the optimizers' fp32 passes with the
AdaGrad landing's gathers and ``index_put_``: no span of the program tells
them apart yet, so its layer is both."""
LAYER = "GR stack and optimizers"
UNIT = "ms"
MOVES = "train_tokens_per_s"
PATTERNS = ("at::native::", "at_cuda_detail::", "CatArrayBatchedCopy")
EXCLUDE = ("Radix", "radix", "Sort", "sort")
PROFILED_STEPS = 2


def read(ctx):
    ms = 1e3 * ctx["trace"].matching(PATTERNS, EXCLUDE)
    return ms / PROFILED_STEPS if ms > 0 else None
