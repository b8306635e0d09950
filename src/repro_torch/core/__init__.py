from repro_torch.core.device import resolve_device
from repro_torch.core.jagged import (NEG_SEG, JaggedBatch, from_dense,
                                     from_row_list, positions, segment_ids,
                                     segment_matrix_mask, to_dense)

__all__ = ["NEG_SEG", "JaggedBatch", "from_dense", "from_row_list",
           "positions", "segment_ids", "segment_matrix_mask", "to_dense",
           "resolve_device"]
