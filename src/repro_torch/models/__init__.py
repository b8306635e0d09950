from repro_torch.models.fuxi import FuXiBlock, fuxi_block
from repro_torch.models.gr import (GRModel, gr_hidden, gr_hidden_sharded,
                                   gr_serve_hidden,
                                   gr_user_embeddings,
                                   gr_user_embeddings_sharded)
from repro_torch.models.hstu import (HSTUBlock, default_attn_fn, hstu_block,
                                     jagged_pointwise_attention,
                                     jagged_pointwise_attention_blocked)

__all__ = ["FuXiBlock", "GRModel", "HSTUBlock", "default_attn_fn",
           "fuxi_block", "gr_hidden",
           "gr_hidden_sharded",
           "gr_serve_hidden", "gr_user_embeddings",
           "gr_user_embeddings_sharded", "hstu_block",
           "jagged_pointwise_attention",
           "jagged_pointwise_attention_blocked"]
