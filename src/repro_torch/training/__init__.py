from repro_torch.training.engine import GREngine, make_gr_step_fn
from repro_torch.training.optim import (AdamWState, adagrad_apply_unique,
                                        adagrad_sparse_update, adamw_init,
                                        adamw_update)
from repro_torch.training.trainer import (GRDenseOut, GRStages, GRTrainState,
                                          TableContribs, clone_state,
                                          gr_pending_slots, gr_train_state,
                                          host_sort_contribs,
                                          host_unique_candidates,
                                          make_gr_stages, make_gr_train_step,
                                          state_tensors, to_device)

__all__ = ["AdamWState", "GRDenseOut", "GREngine", "GRStages", "GRTrainState",
           "TableContribs", "adagrad_apply_unique", "adagrad_sparse_update",
           "adamw_init", "adamw_update", "clone_state", "gr_pending_slots",
           "gr_train_state", "host_sort_contribs", "host_unique_candidates",
           "make_gr_stages", "make_gr_step_fn", "make_gr_train_step",
           "state_tensors", "to_device"]
