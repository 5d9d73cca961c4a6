"""The loss library (port of ihmr_tpu/losses/losses.py).

Each maps batch tensors to (scalar mean loss, per-sample loss (B,)) where the
reference exposes a per-sample variant (those drive snapshot filtering), or
to the scalar alone.

At their kinks the losses take JAX's derivatives, not torch's: d|x|/dx is
+1 at x = 0 (``lax.abs`` selects on x >= 0; ``torch.abs`` gives 0 there),
and min(0, x) splits the gradient in half at x = 0 (``jnp.minimum``;
``torch.clamp(max=0)`` passes all of it). An L1 residual or a finger-prior
term that lands exactly on 0 in fp32 otherwise moves the port's gradient,
and over a long schedule its Adam trajectory, away from the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ihmr_tpu_torch.core.rotations import axis_angle_to_matrix
from ihmr_tpu_torch.device import constant

_EPS = 1e-7


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative is +1 where x >= 0 (0 included), -1 elsewhere: JAX's."""
    return torch.where(x >= 0, x, -x)

# 4-joint chains (proximal -> tip) per finger in the 21-joint convention
_FINGER_CHAINS = np.array(
    [
        [1, 2, 3, 17],  # index
        [4, 5, 6, 18],  # middle
        [7, 8, 9, 20],  # little
        [10, 11, 12, 19],  # ring
        [13, 14, 15, 16],  # thumb
    ]
)
FINGER_JOINT_IDXS = np.concatenate([_FINGER_CHAINS.reshape(-1), _FINGER_CHAINS.reshape(-1) + 21])
_FINGER_IDS = tuple(FINGER_JOINT_IDXS.tolist())  # for ``device.constant``


def hand_type_loss(
    gt_hand_type: torch.Tensor,  # (B, 2) in {0, 1}
    pred_hand_type: torch.Tensor,  # (B, 2) sigmoid probabilities
    hand_type_valid: torch.Tensor,  # (B, 1)
) -> torch.Tensor:
    """Binary cross-entropy of the handedness probabilities, clipped to
    [1e-7, 1 - 1e-7], weighted by validity."""
    p = torch.clamp(pred_hand_type, _EPS, 1.0 - _EPS)
    bce = -(gt_hand_type * torch.log(p) + (1.0 - gt_hand_type) * torch.log(1.0 - p))
    return (bce * hand_type_valid).mean()


def mano_pose_loss(
    gt_pose: torch.Tensor,  # (B, 48) or (B, 45) axis-angle
    pred_pose: torch.Tensor,
    weight: torch.Tensor,  # (B, 1)
    use_hand_rotation: bool = False,
) -> torch.Tensor:
    """L2 between Rodrigues matrices; a 48-d pose drops its global orient
    unless ``use_hand_rotation``."""
    B, dim = gt_pose.shape
    if dim not in (45, 48):
        raise ValueError(f"pose must be 45- or 48-d, got {dim}")
    gt_m = axis_angle_to_matrix(gt_pose.reshape(B, dim // 3, 3))
    pred_m = axis_angle_to_matrix(pred_pose.reshape(B, dim // 3, 3))
    if not use_hand_rotation and dim == 48:
        gt_m, pred_m = gt_m[:, 1:], pred_m[:, 1:]
    diff = (gt_m - pred_m).reshape(B, -1)
    return (diff * diff * weight).mean()


def mano_shape_loss(gt_shape: torch.Tensor, pred_shape: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted L1 on betas."""
    return (_abs(gt_shape - pred_shape) * weight).mean()


def joints_2d_loss(
    gt_joints: torch.Tensor,  # (B, J, 2)
    pred_joints: torch.Tensor,  # (B, J, 2)
    weight: torch.Tensor,  # (B, J, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted L1."""
    w = _abs(gt_joints - pred_joints) * weight
    return w.mean(), w.reshape(w.shape[0], -1).mean(dim=1)


def _align_by_root(joints: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Subtract the right wrist when valid, else the left wrist.

    Samples whose right-wrist validity lies between 1e-7 and 0.5 stay
    unaligned, exactly as in the reference."""
    w0 = weight[:, 0, 0]
    has_right = (w0 > 0.5)[:, None, None]
    no_right = (w0 < _EPS)[:, None, None]
    zero = torch.zeros((), dtype=joints.dtype, device=joints.device)
    root = torch.where(has_right, joints[:, 0:1], torch.where(no_right, joints[:, 21:22], zero))
    return joints - root


def joints_3d_loss(
    gt_joints: torch.Tensor,  # (B, 42, 3)
    pred_joints: torch.Tensor,  # (B, 42, 3)
    weight: torch.Tensor,  # (B, 42, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root-aligned weighted L2."""
    sq = (_align_by_root(gt_joints, weight) - _align_by_root(pred_joints, weight)) ** 2 * weight
    return sq.mean(), sq.reshape(sq.shape[0], -1).mean(dim=1)


def hand_trans_loss(
    gt_trans: torch.Tensor,  # (B, 3) or (B, 1, 3)
    pred_trans: torch.Tensor,
    weight: torch.Tensor,  # (B, 1) or (B, 1, 1)
) -> torch.Tensor:
    """Weighted L2."""
    B = gt_trans.shape[0]
    return ((gt_trans.reshape(B, -1) - pred_trans.reshape(B, -1)) ** 2 * weight.reshape(B, -1)).mean()


def shape_reg_loss(shape_params: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetry prior: L2 between right (first 10) and left (last 10) betas."""
    diff = shape_params[:, :10] - shape_params[:, 10:]
    sq = diff * diff
    return sq.mean(), sq.mean(dim=1)


def shape_residual_loss(pred_shape: torch.Tensor, init_shape: torch.Tensor) -> torch.Tensor:
    """L1 to the initial betas."""
    return _abs(pred_shape - init_shape).mean()


def finger_terms(joints_3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each finger's 4-joint chain -> (C1, C2), (B, 10) each: with bone
    vectors f0, f1, f2, C1 = f2 . (f0 x f1) and C2 = (f0 x f1) . (f1 x f2)."""
    B = joints_3d.shape[0]
    chains = joints_3d[:, constant(_FINGER_IDS, torch.int64, joints_3d.device), :].reshape(B, 10, 4, 3)
    bones = chains[:, :, :3, :] - chains[:, :, 1:, :]  # (B, 10, 3, 3)
    f0, f1, f2 = bones[:, :, 0], bones[:, :, 1], bones[:, :, 2]
    c01 = torch.linalg.cross(f0, f1)
    c12 = torch.linalg.cross(f1, f2)
    return (f2 * c01).sum(-1), (c01 * c12).sum(-1)


def finger_reg_loss(joints_3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planarity/curl prior on each finger's 4-joint chain:
    loss = |C1| - min(0, C2) (``finger_terms``), summed over the 10 fingers."""
    C1, C2 = finger_terms(joints_3d)
    loss = _abs(C1) - torch.minimum(torch.zeros_like(C2), C2)  # (B, 10)
    per_sample = loss.sum(dim=1)
    return per_sample.mean(), per_sample
