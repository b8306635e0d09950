from repro_torch.models.fuxi import FuXiBlock, fuxi_block
from repro_torch.models.gr import (GRModel, gr_append_slots, gr_encode_slots,
                                   gr_encode_slots_flat, gr_hidden,
                                   gr_hidden_sharded, gr_serve_hidden,
                                   gr_serve_row_append, gr_serve_row_kv,
                                   gr_user_embeddings,
                                   gr_user_embeddings_sharded)
from repro_torch.models.hstu import (HSTUBlock, default_attn_fn, hstu_block,
                                     jagged_pointwise_attention,
                                     jagged_pointwise_attention_blocked)
from repro_torch.models.sasrec import SASRecBlock, sasrec_block

__all__ = ["FuXiBlock", "GRModel", "HSTUBlock", "SASRecBlock",
           "default_attn_fn", "fuxi_block", "gr_append_slots",
           "gr_encode_slots", "gr_encode_slots_flat", "gr_hidden",
           "gr_hidden_sharded", "gr_serve_hidden", "gr_serve_row_append",
           "gr_serve_row_kv", "gr_user_embeddings",
           "gr_user_embeddings_sharded", "hstu_block",
           "jagged_pointwise_attention",
           "jagged_pointwise_attention_blocked", "sasrec_block"]
