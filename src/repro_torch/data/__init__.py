from repro_torch.data.kuairand import (drop_negative, five_core_filter,
                                      group_sequences, leave_one_out,
                                      preprocess_log)
from repro_torch.data.loader import GRLoader
from repro_torch.data.synthetic import SyntheticKuaiRand, synth_jagged_batch

__all__ = ["GRLoader", "SyntheticKuaiRand", "drop_negative",
           "five_core_filter", "group_sequences", "leave_one_out",
           "preprocess_log", "synth_jagged_batch"]
