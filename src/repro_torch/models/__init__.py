from repro_torch.models.gr import (GRModel, gr_hidden, gr_serve_hidden,
                                   gr_user_embeddings,
                                   gr_user_embeddings_sharded)
from repro_torch.models.hstu import (HSTUBlock, default_attn_fn, hstu_block,
                                     jagged_pointwise_attention,
                                     jagged_pointwise_attention_blocked)

__all__ = ["GRModel", "HSTUBlock", "default_attn_fn", "gr_hidden",
           "gr_serve_hidden", "gr_user_embeddings",
           "gr_user_embeddings_sharded", "hstu_block",
           "jagged_pointwise_attention",
           "jagged_pointwise_attention_blocked"]
