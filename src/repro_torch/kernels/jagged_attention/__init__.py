from repro_torch.kernels.jagged_attention.ops import (KERNEL_LAUNCHES,
                                                      JaggedAttnPlan,
                                                      PlannedAttention,
                                                      attention_append,
                                                      build_attn_plan,
                                                      jagged_attention,
                                                      make_attn_fn,
                                                      num_pairs_bound)
from repro_torch.kernels.jagged_attention.ref import (attention_append_plain,
                                                      attention_bwd_plain,
                                                      attention_fwd_plain,
                                                      jagged_attention_ref)

__all__ = ["KERNEL_LAUNCHES", "JaggedAttnPlan", "PlannedAttention",
           "attention_append", "build_attn_plan", "jagged_attention",
           "make_attn_fn", "num_pairs_bound", "attention_append_plain",
           "attention_bwd_plain", "attention_fwd_plain",
           "jagged_attention_ref"]
