from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,
                                            clip_by_global_norm,
                                            init_opt_state, make_schedule)
from repro_torch.training.train_state import TrainState

__all__ = ["OptimizerConfig", "adamw_update", "init_opt_state",
           "make_schedule", "clip_by_global_norm", "TrainState"]
