from repro_torch.training.optim import (AdamWState, adagrad_sparse_update,
                                        adamw_init, adamw_update)
from repro_torch.training.trainer import (GRDenseOut, GRStages, GRTrainState,
                                          gr_pending_slots, gr_train_state,
                                          host_unique_candidates,
                                          make_gr_stages, make_gr_train_step,
                                          to_device)

__all__ = ["AdamWState", "GRDenseOut", "GRStages", "GRTrainState",
           "adagrad_sparse_update", "adamw_init", "adamw_update",
           "gr_pending_slots", "gr_train_state", "host_unique_candidates",
           "make_gr_stages", "make_gr_train_step", "to_device"]
