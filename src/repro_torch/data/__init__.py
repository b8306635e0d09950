from repro_torch.data.freq import (ID_FEATURES, batch_id_histogram,
                                  id_frequency_histogram,
                                  stream_id_histogram)
from repro_torch.data.kuairand import (drop_negative, five_core_filter,
                                      group_sequences, leave_one_out,
                                      preprocess_log)
from repro_torch.data.loader import GRLoader
from repro_torch.data.synthetic import SyntheticKuaiRand, synth_jagged_batch

__all__ = ["GRLoader", "ID_FEATURES", "SyntheticKuaiRand",
           "batch_id_histogram", "drop_negative", "five_core_filter",
           "group_sequences", "id_frequency_histogram", "leave_one_out",
           "preprocess_log", "stream_id_histogram", "synth_jagged_batch"]
