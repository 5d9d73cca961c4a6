"""MANO model container (port of ihmr_tpu/mano/model.py).

    v_shaped = v_template + shapedirs . betas
    J        = J_regressor @ v_shaped
    v_posed  = v_shaped + posedirs . vec(R(theta_hand) - I)
    verts    = LBS(v_posed, lbs_weights, global transforms of (orient, theta))
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NUM_VERTS = 778
NUM_JOINTS = 16  # MANO skeleton joints (before fingertip augmentation)
NUM_FACES = 1538
NUM_BETAS = 10
NUM_POSE_JOINTS = 15  # articulated joints (excl. root)

# the five fingertip vertices appended to the 16 joints, [thumb, index,
# middle, ring, pinky]
FINGERTIP_VERTEX_IDS = (744, 320, 443, 554, 671)

# wrist; index 1-3; middle 4-6; pinky 7-9; ring 10-12; thumb 13-15
MANO_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int32)


@dataclass(frozen=True)
class ManoModel:
    """Tensors of one MANO hand.

    Shapes: v_template (778, 3); shapedirs (778, 3, 10); posedirs (135, 2334);
    j_regressor (16, 778); lbs_weights (778, 16); faces (1538, 3) int64
    (Morton-sorted, see loader.sort_faces_spatially)."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    faces: torch.Tensor
    is_rhand: bool = True

    @property
    def device(self) -> torch.device:
        return self.v_template.device
