"""Axis-angle rotations and hand mirroring (port of ihmr_tpu/core/rotations.py).

Only what the OPT path needs: Rodrigues (``axis_angle_to_matrix``) and the
axis-angle mirror (``flip_hand_pose``). Functions act on trailing dims and
broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3).

    Keeps the reference's ``batch_rodrigues`` numerics: 1e-8 is added to the
    vector before its norm, which also fixes the behaviour at theta ~= 0."""
    angle = torch.linalg.norm(aa + _EPS, dim=-1, keepdim=True)  # (..., 1)
    axis = aa / angle
    cos = torch.cos(angle)[..., None]  # (..., 1, 1)
    sin = torch.sin(angle)[..., None]
    outer = axis[..., :, None] * axis[..., None, :]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return cos * eye + (1.0 - cos) * outer + sin * skew(axis)


def flip_hand_pose(pose: torch.Tensor) -> torch.Tensor:
    """Mirror an axis-angle pose across x=0: negate y and z of every 3-vector.

    ``pose`` may be (..., 3*k) flat or (..., k, 3); the shape is kept."""
    flat = pose.shape[-1] != 3 or pose.dim() == 1
    shape = pose.shape
    vecs = pose.reshape(shape[:-1] + (-1, 3)) if flat else pose
    vecs = vecs * torch.tensor([1.0, -1.0, -1.0], dtype=pose.dtype, device=pose.device)
    return vecs.reshape(shape) if flat else vecs
