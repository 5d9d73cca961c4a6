from ihmr_tpu_torch.train.baseline import (
    BaselineBatch,
    BaselineState,
    TrainConfig,
    create_state,
    eval_step,
    forward_and_loss,
    learning_rate_for_epoch,
    set_learning_rate,
    train_step,
)
from ihmr_tpu_torch.train.loops import resume_state, save_state, train_baseline_loop
from ihmr_tpu_torch.train.mlp import (
    init_stage_subnetwork,
    make_stage_select_step,
    make_stage_train_step,
    test_mlp_loop,
    train_mlp_stages,
    warm_pass,
)
from ihmr_tpu_torch.train.stats import AverageMeter, LossStat, OptTimeStat, TimeStat

__all__ = [
    "AverageMeter",
    "BaselineBatch",
    "BaselineState",
    "LossStat",
    "OptTimeStat",
    "TimeStat",
    "TrainConfig",
    "create_state",
    "eval_step",
    "forward_and_loss",
    "init_stage_subnetwork",
    "learning_rate_for_epoch",
    "make_stage_select_step",
    "make_stage_train_step",
    "resume_state",
    "save_state",
    "set_learning_rate",
    "test_mlp_loop",
    "train_baseline_loop",
    "train_mlp_stages",
    "train_step",
    "warm_pass",
]
