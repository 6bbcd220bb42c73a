from .grad import accumulate, compress_grads, decompress_grads, \
    zeros_like_f32
from .optimizer import OptimizerConfig, UPDATES, adamw_update, \
    clip_by_global_norm, global_norm, init_opt_state, lr_at, sgdm_update
from .step import TrainState, init_train_state, loss_and_grads, \
    make_eval_step, make_train_step

__all__ = [
    "OptimizerConfig", "init_opt_state", "adamw_update", "sgdm_update",
    "UPDATES", "lr_at", "global_norm", "clip_by_global_norm",
    "compress_grads", "decompress_grads", "accumulate", "zeros_like_f32",
    "TrainState", "init_train_state", "loss_and_grads", "make_train_step",
    "make_eval_step",
]
