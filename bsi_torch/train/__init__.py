from .checkpoint import AsyncCheckpointWriter, load_checkpoint, save_checkpoint
from .ema import EMAConfig, ema_decay, ema_update, maybe_switch_ema
from .optim import AdamState, Optimizer, global_norm, make_optimizer, warmup_cosine_schedule, warmup_schedule
from .state import TrainState
from .step import make_eval_step, make_sample_fn, make_train_step, module_apply

__all__ = [
    "AdamState",
    "AsyncCheckpointWriter",
    "EMAConfig",
    "Optimizer",
    "TrainState",
    "ema_decay",
    "ema_update",
    "global_norm",
    "load_checkpoint",
    "make_eval_step",
    "make_optimizer",
    "make_sample_fn",
    "make_train_step",
    "maybe_switch_ema",
    "module_apply",
    "save_checkpoint",
    "warmup_cosine_schedule",
    "warmup_schedule",
]
