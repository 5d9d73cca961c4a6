from ihmr_tpu_torch.train.mlp import (
    init_stage_subnetwork,
    make_stage_select_step,
    make_stage_train_step,
    test_mlp_loop,
    train_mlp_stages,
    warm_pass,
)
from ihmr_tpu_torch.train.stats import AverageMeter, LossStat

__all__ = [
    "AverageMeter",
    "LossStat",
    "init_stage_subnetwork",
    "make_stage_select_step",
    "make_stage_train_step",
    "test_mlp_loop",
    "train_mlp_stages",
    "warm_pass",
]
