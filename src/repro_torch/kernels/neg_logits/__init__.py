from repro_torch.kernels.neg_logits.ops import (KERNEL_LAUNCHES, NEG_POOL,
                                                TableGradSink,
                                                fused_recall_lse,
                                                make_share_perms, neg_bwd,
                                                neg_fwd,
                                                prepare_fused_inputs)

__all__ = ["KERNEL_LAUNCHES", "NEG_POOL", "TableGradSink", "fused_recall_lse",
           "make_share_perms", "neg_bwd", "neg_fwd", "prepare_fused_inputs"]
