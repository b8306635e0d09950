from repro_torch.training.engine import GREngine, make_gr_step_fn
from repro_torch.training.optim import (AdaGradState, AdamWState,
                                        adagrad_apply_unique, adagrad_init,
                                        adagrad_sparse_update, adagrad_update,
                                        adamw_init, adamw_update)
from repro_torch.training.trainer import (GRDenseOut, GRStages, GRTrainState,
                                          LMTrainState, TableContribs,
                                          clone_state, gr_pending_slots,
                                          gr_train_state,
                                          host_unique_candidates,
                                          lm_train_state, make_gr_stages,
                                          make_gr_train_step,
                                          make_lm_train_step, state_tensors,
                                          to_device)

__all__ = ["AdaGradState", "AdamWState", "GRDenseOut", "GREngine", "GRStages",
           "GRTrainState", "LMTrainState", "TableContribs",
           "adagrad_apply_unique", "adagrad_init", "adagrad_sparse_update",
           "adagrad_update", "adamw_init", "adamw_update", "clone_state",
           "gr_pending_slots", "gr_train_state", "host_unique_candidates",
           "lm_train_state", "make_gr_stages", "make_gr_step_fn",
           "make_gr_train_step", "make_lm_train_step", "state_tensors",
           "to_device"]
