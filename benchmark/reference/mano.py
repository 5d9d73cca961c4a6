"""Plain MANO decode for the benchmark's reference (float32, plain torch).

The equations of MANO (Romero et al., SIGGRAPH Asia 2017) as IHMR uses them:

    v_shaped = v_template + shapedirs . betas
    J        = J_regressor @ v_shaped
    v_posed  = v_shaped + posedirs^T vec(R(theta_1..15) - I)
    verts    = sum_j w_vj (G_j [v_posed; 1]),  G_j the global transform of
               joint j with its rest position removed

plus the 5 fingertip vertices appended to the 16 joints (21 per hand), the
left hand decoded through the right model with its axis-angles mirrored
(y and z negated) and x negated afterwards, and the left wrist anchored to
the right wrist plus a translation. Rodrigues adds 1e-8 to the vector
before its norm, as the reference's ``batch_rodrigues`` does.

Model tensors are a dict: v_template (778, 3), shapedirs (778, 3, 10),
posedirs (135, 2334), j_regressor (16, 778), lbs_weights (778, 16),
faces (1538, 3) int64.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
FINGERTIPS = (744, 320, 443, 554, 671)
MIRROR_AA = (1.0, -1.0, -1.0)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3)."""
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    skew = torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1), torch.stack([-y, x, zero], -1)], -2
    )
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return cos * eye + (1.0 - cos) * (axis[..., :, None] * axis[..., None, :]) + sin * skew


def mirror_aa(x: torch.Tensor) -> torch.Tensor:
    """Negate y and z of every axis-angle 3-vector of a flat (B, 3k) tensor."""
    s = x.shape
    return (x.reshape(s[0], -1, 3) * x.new_tensor(MIRROR_AA)).reshape(s)


def decode(model: Dict[str, torch.Tensor], orient: torch.Tensor, pose: torch.Tensor, betas: torch.Tensor):
    """One hand per row: (B, 3), (B, 45), (B, 10) -> (verts (B, 778, 3),
    joints (B, 21, 3))."""
    B = orient.shape[0]
    rots = rodrigues(torch.cat([orient, pose], -1).reshape(B, 16, 3))
    v_shaped = model["v_template"] + torch.einsum("bs,vcs->bvc", betas, model["shapedirs"])
    j_rest = torch.einsum("jv,bvc->bjc", model["j_regressor"], v_shaped)
    feat = (rots[:, 1:] - torch.eye(3, dtype=rots.dtype, device=rots.device)).reshape(B, 135)
    v_posed = v_shaped + (feat @ model["posedirs"]).reshape(B, 778, 3)
    glob_r, glob_t = [rots[:, 0]], [j_rest[:, 0]]
    for k in range(1, 16):
        p = PARENTS[k]
        glob_r.append(glob_r[p] @ rots[:, k])
        glob_t.append(glob_t[p] + (glob_r[p] @ (j_rest[:, k] - j_rest[:, p])[..., None])[..., 0])
    R = torch.stack(glob_r, 1)  # (B, 16, 3, 3)
    t = torch.stack(glob_t, 1)  # (B, 16, 3)
    t_rel = t - (R @ j_rest[..., None])[..., 0]
    Rv = torch.einsum("vj,bjik->bvik", model["lbs_weights"], R)
    tv = torch.einsum("vj,bji->bvi", model["lbs_weights"], t_rel)
    verts = (Rv * v_posed[:, :, None, :]).sum(-1) + tv
    return verts, torch.cat([t, verts[:, list(FINGERTIPS)]], 1)


def anchor(rv, rj, lv, lj, trans):
    """Anchor the left wrist to the right wrist plus trans -> (rv, lv, joints (B, 42, 3))."""
    shift = trans[:, None, :] + rj[:, 0:1] - lj[:, 0:1]
    return rv, lv + shift, torch.cat([rj, lj + shift], 1)


def decode_mirrored(model, p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both hands through the right model (the left mirrored) -> (right verts,
    left verts, joints (B, 42, 3)). ``p`` holds the parameter groups
    right_orient, left_orient, right_pose, left_pose, right_shape,
    left_shape and trans."""
    B = p["trans"].shape[0]
    verts, joints = decode(
        model,
        torch.cat([p["right_orient"], mirror_aa(p["left_orient"])]),
        torch.cat([p["right_pose"], mirror_aa(p["left_pose"])]),
        torch.cat([p["right_shape"], p["left_shape"]]),
    )
    m = verts.new_tensor([-1.0, 1.0, 1.0])
    return anchor(verts[:B], joints[:B], verts[B:] * m, joints[B:] * m, p["trans"])


def mirror_model(right: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The x-mirrored left model: with M = diag(-1, 1, 1), R_L = M R_R M, so a
    posedirs row of rotation entry (i, j) changes sign where exactly one of
    i, j is 0, and then its x column changes sign; v_template and shapedirs
    flip x; the face winding reverses."""
    M = right["v_template"].new_tensor([-1.0, 1.0, 1.0])
    sign9 = right["v_template"].new_tensor(
        [1.0 if (i == 0) == (j == 0) else -1.0 for i in range(3) for j in range(3)]
    ).repeat(15)
    pd = right["posedirs"].reshape(135, 778, 3) * sign9[:, None, None] * M
    return {
        "v_template": right["v_template"] * M,
        "shapedirs": right["shapedirs"] * M[None, :, None],
        "posedirs": pd.reshape(135, 2334),
        "j_regressor": right["j_regressor"],
        "lbs_weights": right["lbs_weights"],
        "faces": right["faces"].flip(-1),
    }


def decode_two_models(right, left, pose: torch.Tensor, shape: torch.Tensor, trans: torch.Tensor):
    """The baseline's decode: each hand through its own model. pose (B, 96) =
    [right orient, right pose, left orient, left pose], shape (B, 20)."""
    rv, rj = decode(right, pose[:, 0:3], pose[:, 3:48], shape[:, :10])
    lv, lj = decode(left, pose[:, 48:51], pose[:, 51:96], shape[:, 10:])
    return anchor(rv, rj, lv, lj, trans)


def project(joints: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Weak perspective: s * (xy + t), cam = (s, tx, ty)."""
    return cam[:, None, 0:1] * (joints[..., :2] + cam[:, None, 1:3])
