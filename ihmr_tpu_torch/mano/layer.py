"""Differentiable MANO decode and two-hand composition (port of
ihmr_tpu/mano/layer.py).

  * 16 LBS joints + 5 fingertip vertices -> 21 joints per hand;
  * the mirrored single-model trick for left hands: flip y/z of the left
    axis-angle params, decode with the right model at batch 2B, negate x of
    the outputs;
  * the left hand anchored to the right wrist plus a predicted translation;
  * ``HandParams``, the flat 122-d parameter layout and its groups.

Matmuls here must run in full fp32 on the card (the JAX decode pins
Precision.HIGH): callers set ``device.set_fp32_matmul_precision()``.

Not ported yet: the stage-hoist payloads (``two_hand_*_payload`` /
``two_hand_decode_from_*``). They are exact partial evaluations of this
decode, so the OPT engine gives the same results without them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ihmr_tpu_torch.core.rotations import axis_angle_to_matrix, flip_hand_pose
from ihmr_tpu_torch.mano.model import FINGERTIP_VERTEX_IDS, MANO_PARENTS, ManoModel

_PARENTS = [int(p) for p in MANO_PARENTS]


def mano_decode(
    model: ManoModel,
    global_orient: torch.Tensor,  # (B, 3)
    hand_pose: torch.Tensor,  # (B, 45)
    betas: torch.Tensor,  # (B, 10)
    hands_mean: Optional[torch.Tensor] = None,  # (45,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-hand MANO forward -> (verts (B, 778, 3), joints (B, 16, 3))."""
    if hands_mean is not None:
        hand_pose = hand_pose + hands_mean
    B = global_orient.shape[0]
    dtype = model.v_template.dtype
    pose = torch.cat([global_orient, hand_pose], dim=-1).reshape(B, 16, 3)
    rots = axis_angle_to_matrix(pose.to(dtype))  # (B, 16, 3, 3)
    v_shaped, j_rest, rel_j = shape_rest_parts(model, betas)
    return _decode_from_parts(model, rots, v_shaped, j_rest, rel_j)


def shape_rest_parts(
    model: ManoModel, betas: torch.Tensor  # (B, 10)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The betas-only terms: (v_shaped (B,778,3), j_rest (B,16,3), rel_j
    (B,16,3) parent-relative rest offsets)."""
    dtype = model.v_template.dtype
    v_shaped = model.v_template + torch.einsum("bs,vcs->bvc", betas.to(dtype), model.shapedirs)
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    parent_pos = torch.cat(
        [torch.zeros_like(j_rest[:, :1]), j_rest[:, _PARENTS[1:]]], dim=1
    )
    return v_shaped, j_rest, j_rest - parent_pos


def _fk_chain(rots: torch.Tensor, rel_j: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics along the static MANO tree.

    rots (B,16,3,3) local rotations, rel_j (B,16,3) parent-relative rest
    offsets -> (global rotations (B,16,3,3), global positions (B,16,3)).
    The JAX package has two spellings of this recursion (``_fk_chain`` and
    the elementwise ``_fk_elem``); they compute the same thing."""
    glob_rot = [rots[:, 0]]
    glob_pos = [rel_j[:, 0]]
    for k in range(1, 16):
        p = _PARENTS[k]
        glob_rot.append(glob_rot[p] @ rots[:, k])
        glob_pos.append(glob_pos[p] + (glob_rot[p] @ rel_j[:, k, :, None])[..., 0])
    return torch.stack(glob_rot, dim=1), torch.stack(glob_pos, dim=1)


def _decode_from_parts(
    model: ManoModel,
    rots: torch.Tensor,  # (B, 16, 3, 3) local joint rotations incl. root
    v_shaped: torch.Tensor,  # (B, 778, 3)
    j_rest: torch.Tensor,  # (B, 16, 3)
    rel_j: torch.Tensor,  # (B, 16, 3)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose blendshapes + FK + linear blend skinning."""
    B = rots.shape[0]
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_feature = (rots[:, 1:] - eye).reshape(B, 135)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(B, 778, 3)

    R, t = _fk_chain(rots, rel_j)
    # remove the rest pose: per-joint affine [R | t - R @ j_rest]
    t_rel = t - (R @ j_rest[..., None])[..., 0]
    Rv = torch.einsum("vj,bjik->bvik", model.lbs_weights, R)  # (B, 778, 3, 3)
    tv = torch.einsum("vj,bji->bvi", model.lbs_weights, t_rel)
    verts = (Rv * v_posed[:, :, None, :]).sum(-1) + tv
    return verts, t


def joints21(verts: torch.Tensor, lbs_joints: torch.Tensor) -> torch.Tensor:
    """Append the 5 fingertip vertices to the 16 LBS joints -> (B, 21, 3)."""
    return torch.cat([lbs_joints, verts[:, list(FINGERTIP_VERTEX_IDS)]], dim=1)


@dataclass(frozen=True)
class HandParams:
    """The 122-dim two-hand parameter vector split into its factor groups.

    Flat layout: [cam(3) | right orient(3) | right pose(45) | left orient(3) |
    left pose(45) | right betas(10) | left betas(10) | trans(3)]."""

    cam: torch.Tensor  # (..., 3)
    right_orient: torch.Tensor  # (..., 3)
    left_orient: torch.Tensor  # (..., 3)
    right_pose: torch.Tensor  # (..., 45)
    left_pose: torch.Tensor  # (..., 45)
    right_shape: torch.Tensor  # (..., 10)
    left_shape: torch.Tensor  # (..., 10)
    trans: torch.Tensor  # (..., 3)

    @classmethod
    def from_flat(cls, params: torch.Tensor) -> "HandParams":
        if params.shape[-1] != 122:
            raise ValueError(f"expected (..., 122) hand params, got {tuple(params.shape)}")
        return cls(
            cam=params[..., 0:3],
            right_orient=params[..., 3:6],
            right_pose=params[..., 6:51],
            left_orient=params[..., 51:54],
            left_pose=params[..., 54:99],
            right_shape=params[..., 99:109],
            left_shape=params[..., 109:119],
            trans=params[..., 119:122],
        )

    def to_flat(self) -> torch.Tensor:
        return torch.cat(
            [self.cam, self.pose_params, self.shape_params, self.trans], dim=-1
        )

    @property
    def pose_params(self) -> torch.Tensor:
        """(..., 96) = [right 48 | left 48]."""
        return torch.cat([self.right_orient, self.right_pose, self.left_orient, self.left_pose], dim=-1)

    @property
    def shape_params(self) -> torch.Tensor:
        """(..., 20) = [right 10 | left 10]."""
        return torch.cat([self.right_shape, self.left_shape], dim=-1)


def two_hand_decode_mirrored(
    right_model: ManoModel,
    right_orient: torch.Tensor,
    left_orient: torch.Tensor,
    right_pose: torch.Tensor,
    left_pose: torch.Tensor,
    right_shape: torch.Tensor,
    left_shape: torch.Tensor,
    trans: torch.Tensor,
    hands_mean: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both hands through ONE (right) model at batch 2B.

    Returns (right_verts (B,778,3), left_verts (B,778,3), joints (B,42,3)).
    The left mesh keeps the right model's winding, which faces inward after
    the mirror; consumers flip it (``faces.flip(-1)``)."""
    B = right_orient.shape[0]
    orient = torch.cat([right_orient, flip_hand_pose(left_orient)], dim=0)
    pose = torch.cat([right_pose, flip_hand_pose(left_pose)], dim=0)
    betas = torch.cat([right_shape, left_shape], dim=0)
    verts, lbs_j = mano_decode(right_model, orient, pose, betas, hands_mean)
    return _mirror_and_anchor(verts, lbs_j, trans, B)


def _mirror_and_anchor(
    verts: torch.Tensor,  # (2B, 778, 3) right-model decode, [right | flipped-left]
    lbs_j: torch.Tensor,  # (2B, 16, 3)
    trans: torch.Tensor,  # (B, 3)
    B: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mirror the left half and anchor its wrist to the right wrist + trans."""
    joints = joints21(verts, lbs_j)
    right_verts, left_verts = verts[:B], verts[B:]
    right_joints, left_joints = joints[:B], joints[B:]
    mirror = torch.tensor([-1.0, 1.0, 1.0], dtype=verts.dtype, device=verts.device)
    left_verts = left_verts * mirror
    left_joints = left_joints * mirror
    shift = trans[:, None, :] + right_joints[:, 0:1, :] - left_joints[:, 0:1, :]
    left_verts = left_verts + shift
    left_joints = left_joints + shift
    return right_verts, left_verts, torch.cat([right_joints, left_joints], dim=1)
