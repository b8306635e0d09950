from repro_torch.kernels.neg_logits.ops import (KERNEL_LAUNCHES,
                                                LAUNCH_KNOBS, NEG_POOL,
                                                ShareLayout, TableGradSink,
                                                bwd_row_split,
                                                fused_recall_lse,
                                                fwd_row_split,
                                                make_share_perms, neg_bwd,
                                                neg_fwd, neg_logits,
                                                neg_logits_bwd,
                                                neg_logits_fwd,
                                                nl_fwd_dims,
                                                prepare_fused_inputs,
                                                share_layout)
from repro_torch.kernels.neg_logits.ref import neg_logits_ref

__all__ = ["KERNEL_LAUNCHES", "LAUNCH_KNOBS", "NEG_POOL", "ShareLayout",
           "TableGradSink", "bwd_row_split", "fused_recall_lse",
           "fwd_row_split", "make_share_perms", "neg_bwd", "neg_fwd",
           "neg_logits", "neg_logits_bwd", "neg_logits_fwd",
           "neg_logits_ref", "nl_fwd_dims", "prepare_fused_inputs",
           "share_layout"]
