from repro_torch.kernels.jagged_attention.ops import (KERNEL_LAUNCHES,
                                                      JaggedAttnPlan,
                                                      PlannedAttention,
                                                      build_attn_plan,
                                                      jagged_attention,
                                                      make_attn_fn,
                                                      num_pairs_bound)
from repro_torch.kernels.jagged_attention.ref import (attention_fwd_plain,
                                                      jagged_attention_ref)

__all__ = ["KERNEL_LAUNCHES", "JaggedAttnPlan", "PlannedAttention",
           "build_attn_plan", "jagged_attention", "make_attn_fn",
           "num_pairs_bound", "attention_fwd_plain", "jagged_attention_ref"]
