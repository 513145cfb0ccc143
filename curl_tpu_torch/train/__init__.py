"""Training and evaluation: state and optimizer, steps, checkpoints, and the
single-process Trainer and Evaluator."""

from curl_tpu_torch.train import checkpoint
from curl_tpu_torch.train.loop import Evaluator, Trainer, build_model
from curl_tpu_torch.train.state import (
    Optimizer,
    TrainState,
    make_optimizer,
    onecycle_schedule,
    param_count,
)
from curl_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    stack_eval_totals,
    summarize_eval,
)

__all__ = [
    "Evaluator",
    "Optimizer",
    "TrainState",
    "Trainer",
    "build_model",
    "checkpoint",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "onecycle_schedule",
    "param_count",
    "stack_eval_totals",
    "summarize_eval",
]
