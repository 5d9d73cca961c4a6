"""Weak-perspective projection (port of ihmr_tpu/core/projection.py)."""

from __future__ import annotations

import torch


def orthographic_project(points: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points, (..., 3) cameras (s, tx, ty) -> (..., N, 2) = s * (xy + t)."""
    cam = camera[..., None, :]
    xy = points[..., :2] + cam[..., 1:3]
    return cam[..., 0:1] * xy
