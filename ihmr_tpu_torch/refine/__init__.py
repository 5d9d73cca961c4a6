from ihmr_tpu_torch.refine.opt_engine import (
    OptBatch,
    OptConfig,
    compute_losses,
    forward,
    optimize_batch,
    params_from_init,
    run_stage,
)
from ihmr_tpu_torch.refine.schedule import (
    OPT_DEFAULT_LOSS_WEIGHTS,
    Stage,
    check_valid_loss,
    opt_default,
)

__all__ = [
    "OPT_DEFAULT_LOSS_WEIGHTS",
    "OptBatch",
    "OptConfig",
    "Stage",
    "check_valid_loss",
    "compute_losses",
    "forward",
    "opt_default",
    "optimize_batch",
    "params_from_init",
    "run_stage",
]
