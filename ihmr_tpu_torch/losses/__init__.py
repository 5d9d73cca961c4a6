from ihmr_tpu_torch.losses.losses import (
    finger_reg_loss,
    hand_trans_loss,
    joints_2d_loss,
    joints_3d_loss,
    shape_reg_loss,
)

__all__ = [
    "finger_reg_loss",
    "hand_trans_loss",
    "joints_2d_loss",
    "joints_3d_loss",
    "shape_reg_loss",
]
