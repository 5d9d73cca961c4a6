"""Differentiable MANO decode and two-hand composition (port of
ihmr_tpu/mano/layer.py).

  * 16 LBS joints + 5 fingertip vertices -> 21 joints per hand;
  * the mirrored single-model trick for left hands: flip y/z of the left
    axis-angle params, decode with the right model at batch 2B, negate x of
    the outputs; and the two-model decode of baseline training
    (``two_hand_decode``, with ``loader.mirror_mano_model`` as the left model);
  * the left hand anchored to the right wrist plus a predicted translation;
  * ``HandParams``, the flat 122-d parameter layout and its groups;
  * the stage-hoist payloads of the OPT engine (``two_hand_*_payload`` and
    ``two_hand_decode_from_*``): exact partial evaluations of the mirrored
    decode against the groups a refinement stage keeps frozen (without the
    JAX package's ``hands_mean``, which no ported caller sets yet).

Matmuls here must run in full fp32 on the card (the JAX decode pins
Precision.HIGH): callers set ``device.set_fp32_matmul_precision()``.
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
    the elementwise ``_fk_elem`` of its hoisted pose stage); they compute
    the same thing, so the port keeps one."""
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


def two_hand_identity_orient_payload(
    right_model: ManoModel,
    right_pose: torch.Tensor,  # (B, 45)
    left_pose: torch.Tensor,  # (B, 45)
    right_shape: torch.Tensor,  # (B, 10)
    left_shape: torch.Tensor,  # (B, 10)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both hands decoded at identity global orient -> (verts_id (2B,778,3),
    lbs_j_id (2B,16,3)), in the mirrored 2B layout.

    The global orient left-multiplies every joint's global transform by a
    rotation about the rest root (the pose blendshapes exclude the root,
    skinning is linear with weights summing to 1), so for any orient R0

        verts(R0) = R0 @ (verts_id - j0) + j0,   j0 = lbs_j_id[:, 0]

    exactly (``two_hand_decode_from_identity``)."""
    pose = torch.cat([right_pose, flip_hand_pose(left_pose)], dim=0)
    betas = torch.cat([right_shape, left_shape], dim=0)
    zero_orient = pose.new_zeros((pose.shape[0], 3))
    return mano_decode(right_model, zero_orient, pose, betas)


def two_hand_decode_from_identity(
    verts_id: torch.Tensor,  # (2B, 778, 3)
    lbs_j_id: torch.Tensor,  # (2B, 16, 3)
    right_orient: torch.Tensor,  # (B, 3)
    left_orient: torch.Tensor,  # (B, 3)
    trans: torch.Tensor,  # (B, 3)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply the global orients to an identity-orient payload; the same
    triple as ``two_hand_decode_mirrored``."""
    B = right_orient.shape[0]
    orient = torch.cat([right_orient, flip_hand_pose(left_orient)], dim=0)
    R0 = axis_angle_to_matrix(orient.to(verts_id.dtype))  # (2B, 3, 3)
    pivot = lbs_j_id[:, 0:1]  # the rest root joint, the FK rotation pivot
    verts = torch.einsum("bij,bvj->bvi", R0, verts_id - pivot) + pivot
    lbs_j = torch.einsum("bij,bnj->bni", R0, lbs_j_id - pivot) + pivot
    return _mirror_and_anchor(verts, lbs_j, trans, B)


def two_hand_pose_payload(
    right_model: ManoModel,
    right_orient: torch.Tensor,  # (B, 3)
    left_orient: torch.Tensor,  # (B, 3)
    right_shape: torch.Tensor,  # (B, 10)
    left_shape: torch.Tensor,  # (B, 10)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode terms a pose-only stage keeps constant, in the mirrored 2B
    layout: the betas-only rest parts (``shape_rest_parts``) and the frozen
    root rotation -> (v_shaped, j_rest, rel_j, rot0 (2B,3,3))."""
    orient = torch.cat([right_orient, flip_hand_pose(left_orient)], dim=0)
    betas = torch.cat([right_shape, left_shape], dim=0)
    rot0 = axis_angle_to_matrix(orient.to(right_model.v_template.dtype))
    v_shaped, j_rest, rel_j = shape_rest_parts(right_model, betas)
    return v_shaped, j_rest, rel_j, rot0


def two_hand_decode_from_pose_payload(
    right_model: ManoModel,
    payload: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    right_pose: torch.Tensor,  # (B, 45)
    left_pose: torch.Tensor,  # (B, 45)
    trans: torch.Tensor,  # (B, 3)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode with the rest parts and the root rotation taken from
    ``two_hand_pose_payload``: finger rotations, pose blendshapes, FK and
    skinning only. The same triple as ``two_hand_decode_mirrored``."""
    v_shaped, j_rest, rel_j, rot0 = payload
    B = right_pose.shape[0]
    hand_pose = torch.cat([right_pose, flip_hand_pose(left_pose)], dim=0)
    rots_f = axis_angle_to_matrix(hand_pose.reshape(2 * B, 15, 3).to(v_shaped.dtype))
    rots = torch.cat([rot0[:, None], rots_f], dim=1)  # (2B, 16, 3, 3)
    verts, lbs_j = _decode_from_parts(right_model, rots, v_shaped, j_rest, rel_j)
    return _mirror_and_anchor(verts, lbs_j, trans, B)


def two_hand_shape_affine_payload(
    right_model: ManoModel,
    right_orient: torch.Tensor,  # (B, 3)
    left_orient: torch.Tensor,  # (B, 3)
    right_pose: torch.Tensor,  # (B, 45)
    left_pose: torch.Tensor,  # (B, 45)
    right_shape0: torch.Tensor,  # (B, 10)
    left_shape0: torch.Tensor,  # (B, 10)
):
    """The two-hand decode as an affine function of the 20 shape
    coefficients, from ONE decode at 21x the batch.

    With pose and orient fixed, every step of the decode (blendshapes, joint
    regression, FK translations, skinning, the mirror and anchor at trans=0)
    is affine in the betas, so

        out(shape0 + d) = out(shape0) + sum_i d_i (out(shape0 + e_i) - out(shape0))

    holds for any d. Returns (base, basis): base = (rv0, lv0, j0) at
    (shape0, trans=0), basis = the matching (20, B, ...) deltas in the order
    right e_0..e_9, left e_0..e_9."""
    B = right_orient.shape[0]
    dtype, dev = right_shape0.dtype, right_shape0.device
    K = 21  # base + 20 unit directions

    def tile(x):
        return x[None].expand((K,) + x.shape).reshape((K * B,) + x.shape[1:])

    eye = torch.eye(10, dtype=dtype, device=dev)
    zero = torch.zeros((10, 10), dtype=dtype, device=dev)
    base_row = torch.zeros((1, 10), dtype=dtype, device=dev)
    d_right = torch.cat([base_row, eye, zero], dim=0)  # (21, 10)
    d_left = torch.cat([base_row, zero, eye], dim=0)
    shape_r = (right_shape0[None] + d_right[:, None]).reshape(K * B, 10)
    shape_l = (left_shape0[None] + d_left[:, None]).reshape(K * B, 10)
    rv, lv, joints = two_hand_decode_mirrored(
        right_model,
        tile(right_orient),
        tile(left_orient),
        tile(right_pose),
        tile(left_pose),
        shape_r,
        shape_l,
        torch.zeros((K * B, 3), dtype=dtype, device=dev),
    )

    def split(x):  # the base is copied out so that the 21x decode is freed
        x = x.reshape((K, B) + x.shape[1:])
        return x[0].clone(), x[1:] - x[0]

    (rv0, brv), (lv0, blv), (j0, bj) = split(rv), split(lv), split(joints)
    return (rv0, lv0, j0), (brv, blv, bj)


def two_hand_decode_from_shape_affine(
    base,  # (rv0 (B,778,3), lv0 (B,778,3), j0 (B,42,3)) at (shape0, trans=0)
    basis,  # ((20,B,778,3), (20,B,778,3), (20,B,42,3)) directional deltas
    right_shape0: torch.Tensor,  # (B, 10)
    left_shape0: torch.Tensor,  # (B, 10)
    right_shape: torch.Tensor,  # (B, 10)
    left_shape: torch.Tensor,  # (B, 10)
    trans: torch.Tensor,  # (B, 3)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate the affine shape payload at new shapes: one (20, B, ., 3) x
    (B, 20) contraction per output. The same triple as
    ``two_hand_decode_mirrored``."""
    rv0, lv0, j0 = base
    brv, blv, bj = basis
    d = torch.cat([right_shape - right_shape0, left_shape - left_shape0], dim=-1).to(rv0.dtype)  # (B, 20)
    rv = rv0 + torch.einsum("kbvc,bk->bvc", brv, d)
    lv = lv0 + torch.einsum("kbvc,bk->bvc", blv, d)
    j = j0 + torch.einsum("kbnc,bk->bnc", bj, d)
    t = trans[:, None, :]
    return rv, lv + t, torch.cat([j[:, :21], j[:, 21:] + t], dim=1)


def two_hand_decode(
    right_model: ManoModel,
    left_model: ManoModel,
    pose_params: torch.Tensor,  # (B, 96)
    shape_params: torch.Tensor,  # (B, 20)
    trans: torch.Tensor,  # (B, 3)
    hands_mean_right: Optional[torch.Tensor] = None,
    hands_mean_left: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-model decode (the baseline path): each hand through its own model,
    the left wrist anchored to the right wrist + trans. Returns (right_verts
    (B,778,3), left_verts (B,778,3), joints (B,42,3))."""
    outs = []
    for model, mean, pose_shift, betas_shift in (
        (right_model, hands_mean_right, 0, 0),
        (left_model, hands_mean_left, 48, 10),
    ):
        orient = pose_params[:, pose_shift : pose_shift + 3]
        pose = pose_params[:, pose_shift + 3 : pose_shift + 48]
        betas = shape_params[:, betas_shift : betas_shift + 10]
        verts, lbs_j = mano_decode(model, orient, pose, betas, mean)
        outs.append((verts, joints21(verts, lbs_j)))
    (right_verts, right_joints), (left_verts, left_joints) = outs
    shift = trans[:, None, :] + right_joints[:, 0:1, :] - left_joints[:, 0:1, :]
    return right_verts, left_verts + shift, torch.cat([right_joints, left_joints + shift], dim=1)
