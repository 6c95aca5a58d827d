"""The train and eval steps and the checkpoints of the port, both families
(port of ``i2pnet_tpu/train``)."""

from i2pnet_tpu_torch.train.state import (
    TrainState,
    clip_by_global_norm_,
    create_train_state,
    make_optimizer,
)
from i2pnet_tpu_torch.train.step import (
    make_accum_train_step,
    make_eval_step,
    make_eval_step_proj,
    make_train_step,
    make_train_step_proj,
)

__all__ = [
    "TrainState",
    "clip_by_global_norm_",
    "create_train_state",
    "make_accum_train_step",
    "make_eval_step",
    "make_eval_step_proj",
    "make_optimizer",
    "make_train_step",
    "make_train_step_proj",
]
