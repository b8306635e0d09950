from repro_torch.kernels.neg_logits.ops import (KERNEL_LAUNCHES, NEG_POOL,
                                                TableGradSink,
                                                fused_recall_lse,
                                                make_share_perms, neg_bwd,
                                                neg_fwd, neg_logits,
                                                neg_logits_bwd,
                                                neg_logits_fwd,
                                                prepare_fused_inputs)
from repro_torch.kernels.neg_logits.ref import neg_logits_ref

__all__ = ["KERNEL_LAUNCHES", "NEG_POOL", "TableGradSink", "fused_recall_lse",
           "make_share_perms", "neg_bwd", "neg_fwd", "neg_logits",
           "neg_logits_bwd", "neg_logits_fwd", "neg_logits_ref",
           "prepare_fused_inputs"]
