from ihmr_tpu_torch.losses.losses import (
    finger_reg_loss,
    hand_trans_loss,
    joints_2d_loss,
    joints_3d_loss,
    mano_pose_loss,
    mano_shape_loss,
    shape_reg_loss,
    shape_residual_loss,
)

__all__ = [
    "finger_reg_loss",
    "hand_trans_loss",
    "joints_2d_loss",
    "joints_3d_loss",
    "mano_pose_loss",
    "mano_shape_loss",
    "shape_reg_loss",
    "shape_residual_loss",
]
