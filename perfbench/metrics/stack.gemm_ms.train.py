"""stack.gemm_ms.train: device milliseconds a step in cuBLAS's and
CUTLASS's matrix products (the GR stack's projections and FFN), from the
profiled steady steps, by the kernel-name patterns below."""
LAYER = "GR stack"
UNIT = "ms"
MOVES = "train_tokens_per_s"
PATTERNS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
PROFILED_STEPS = 2


def read(ctx):
    ms = 1e3 * ctx["trace"].matching(PATTERNS)
    return ms / PROFILED_STEPS if ms > 0 else None
