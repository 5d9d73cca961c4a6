from ihmr_tpu_torch.core.projection import orthographic_project
from ihmr_tpu_torch.core.rotations import axis_angle_to_matrix, flip_hand_pose

__all__ = ["axis_angle_to_matrix", "flip_hand_pose", "orthographic_project"]
