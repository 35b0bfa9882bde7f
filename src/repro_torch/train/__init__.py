from .optimizer import AdamWConfig, adamw_update, init_opt_state, lr_schedule
from .train_step import init_train_state, make_train_step

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "init_train_state",
           "lr_schedule", "make_train_step"]
