"""The losses IHMR-OPT and IHMR-MLP use (port of ihmr_tpu/losses/losses.py).

Each maps batch tensors to (scalar mean loss, per-sample loss (B,)) where the
reference exposes a per-sample variant (those drive snapshot filtering), or
to the scalar alone. Not ported yet: hand_type_loss (baseline training).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ihmr_tpu_torch.core.rotations import axis_angle_to_matrix

_EPS = 1e-7

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
    return ((gt_shape - pred_shape).abs() * weight).mean()


def joints_2d_loss(
    gt_joints: torch.Tensor,  # (B, J, 2)
    pred_joints: torch.Tensor,  # (B, J, 2)
    weight: torch.Tensor,  # (B, J, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted L1."""
    w = (gt_joints - pred_joints).abs() * weight
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
    return (pred_shape - init_shape).abs().mean()


def finger_reg_loss(joints_3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planarity/curl prior on each finger's 4-joint chain.

    With bone vectors f0, f1, f2: C1 = f2 . (f0 x f1), C2 = (f0 x f1) .
    (f1 x f2); loss = |C1| - min(0, C2), summed over the 10 fingers."""
    B = joints_3d.shape[0]
    chains = joints_3d[:, FINGER_JOINT_IDXS, :].reshape(B, 10, 4, 3)
    bones = chains[:, :, :3, :] - chains[:, :, 1:, :]  # (B, 10, 3, 3)
    f0, f1, f2 = bones[:, :, 0], bones[:, :, 1], bones[:, :, 2]
    c01 = torch.linalg.cross(f0, f1)
    c12 = torch.linalg.cross(f1, f2)
    C1 = (f2 * c01).sum(-1)
    C2 = (c01 * c12).sum(-1)
    loss = C1.abs() - torch.clamp(C2, max=0.0)  # (B, 10)
    per_sample = loss.sum(dim=1)
    return per_sample.mean(), per_sample
