"""Axis-angle rotations and hand mirroring (port of ihmr_tpu/core/rotations.py).

Rodrigues (``axis_angle_to_matrix``), its inverse through a quaternion
(``matrix_to_quaternion``, ``quaternion_to_axis_angle``,
``matrix_to_axis_angle``), the axis-angle mirror (``flip_hand_pose``) and
the rotation augmentation's host helpers (``rotate_orient_z``,
``rotate_joints_2d``, ``rotate_joints_3d``, numpy in and out with the JAX
package's dtypes). Tensor functions act on trailing dims and broadcast over
leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch

from ihmr_tpu_torch.device import constant

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
    vecs = vecs * constant((1.0, -1.0, -1.0), pose.dtype, pose.device)
    return vecs.reshape(shape) if flat else vecs


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) unit quaternion (w, x, y, z).

    Branchless Shepperd: all four candidate constructions, the one with the
    largest pivot picked by ``argmax`` (the first on a tie), then w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=_EPS))  # 2 * |pivot component|
    q0, q1, q2, q3 = qw.unbind(-1)
    cands = torch.stack([
        torch.stack([q0, (m21 - m12) / q0, (m02 - m20) / q0, (m10 - m01) / q0], dim=-1),
        torch.stack([(m21 - m12) / q1, q1, (m01 + m10) / q1, (m02 + m20) / q1], dim=-1),
        torch.stack([(m02 - m20) / q2, (m01 + m10) / q2, q2, (m12 + m21) / q2], dim=-1),
        torch.stack([(m10 - m01) / q3, (m02 + m20) / q3, (m12 + m21) / q3, q3], dim=-1),
    ], dim=-2)  # (..., 4, 4)
    best = torch.argmax(qw, dim=-1)[..., None, None].expand(*qw.shape[:-1], 1, 4)
    q = torch.gather(cands, -2, best)[..., 0, :] * 0.5
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3) axis-angle."""
    w, xyz = q[..., 0], q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    half = torch.atan2(sin_half, w)
    scale = torch.where(sin_half > 1e-7, 2.0 * half / torch.clamp(sin_half, min=_EPS), 2.0)
    return xyz * scale[..., None]


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


def _z_rotation(angle_deg: float) -> np.ndarray:
    """Rodrigues of (0, 0, -pi * angle / 180) in float32, as a numpy (3, 3)."""
    rz = np.array([0.0, 0.0, -np.pi * angle_deg / 180.0], np.float32)
    return axis_angle_to_matrix(torch.from_numpy(rz)).numpy()


def rotate_orient_z(orient: np.ndarray, angle_deg: float) -> np.ndarray:
    """A z-axis image rotation composed into a global orient (float32, host):
    Rz(-angle) @ R(orient), back to axis-angle."""
    orient = np.asarray(orient, np.float32).reshape(3)
    m = _z_rotation(angle_deg) @ axis_angle_to_matrix(torch.from_numpy(orient)).numpy()
    return matrix_to_axis_angle(torch.from_numpy(m)).numpy().reshape(3)


def rotate_joints_2d(joints: np.ndarray, origin: np.ndarray, angle_deg: float) -> np.ndarray:
    """2D points rotated about ``origin`` by ``angle_deg`` in image convention
    (numpy, float64 as the JAX package computes it)."""
    a = -angle_deg / 180.0 * np.pi
    d = joints - origin
    c, s = np.cos(a), np.sin(a)
    x = origin[:, 0] + c * d[:, 0] - s * d[:, 1]
    y = origin[:, 1] + s * d[:, 0] + c * d[:, 1]
    return np.stack([x, y], axis=1)


def rotate_joints_3d(joints: np.ndarray, angle_deg: float) -> np.ndarray:
    """(N, 3) points rotated about the camera z-axis (float32 matrix)."""
    return (_z_rotation(angle_deg) @ joints.T).T
