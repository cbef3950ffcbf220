from simhand_tpu_torch.train.loop import make_eval_step, make_train_step
from simhand_tpu_torch.train.optimizer import Optimizer, OptimizerConfig, make_schedule
from simhand_tpu_torch.train.state import TrainState, create_train_state

__all__ = [
    "Optimizer",
    "OptimizerConfig",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_schedule",
    "make_train_step",
]
