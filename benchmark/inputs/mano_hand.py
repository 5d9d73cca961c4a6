"""The synthetic right hand at MANO's published sizes (778 vertices, 1538
faces, 16 joints, 10 shape and 135 pose-corrective directions).

A frozen copy of the port's ``mano/loader.py::synthetic_mano_arrays`` (the
licensed MANO pickles are not in the repository): a convex deformation of a
Fibonacci sphere whose hull is a closed, outward-wound mesh, five finger
rays of joints, skinning weights falling off with the distance to each
joint, smooth random blend shapes; faces padded to 1538 and sorted by the
Morton code of their rest-pose centroids. The hand is part of the
configuration, not of a run: it is always drawn from seed 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

NUM_VERTS, NUM_FACES, NUM_JOINTS, NUM_BETAS, NUM_POSE_JOINTS = 778, 1538, 16, 10, 15


def _spread_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v


def _morton_sorted(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    centroid = v[f].mean(axis=1)
    lo = centroid.min(0)
    span = np.maximum(centroid.max(0) - lo, 1e-9)
    q = np.clip(((centroid - lo) / span * 1023).astype(np.int64), 0, 1023)
    code = _spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << np.uint64(1)) | (_spread_bits(q[:, 2]) << np.uint64(2))
    return f[np.argsort(code, kind="stable")]


def _hull_faces(points: np.ndarray) -> np.ndarray:
    from scipy.spatial import ConvexHull

    faces = ConvexHull(points).simplices.astype(np.int64)
    tri = points[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    outward = np.einsum("fd,fd->f", normals, tri.mean(axis=1) - points.mean(axis=0)) > 0
    faces[~outward] = faces[~outward][:, ::-1]
    return faces


def arrays(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    i = np.arange(NUM_VERTS, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / NUM_VERTS)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    sphere = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], axis=1)
    radii = 0.04 * (1.0 + 0.35 * sphere[:, 0] ** 2 + 0.2 * sphere[:, 1] ** 2)
    v_template = sphere * radii[:, None]
    v_template[:, 0] += 0.04
    faces = _hull_faces(v_template)
    if faces.shape[0] >= NUM_FACES:
        faces = faces[:NUM_FACES]
    else:
        faces = np.concatenate([faces, faces[np.resize(np.arange(faces.shape[0]), NUM_FACES - faces.shape[0])]], axis=0)
    faces = _morton_sorted(np.asarray(v_template, np.float64), faces)
    j_pos = np.zeros((NUM_JOINTS, 3))
    dirs = [np.array([1.0, y, 0.15 * z]) / np.linalg.norm([1.0, y, 0.15 * z])
            for y, z in [(0.5, 1), (0.2, 0), (-0.4, -1), (-0.15, -0.5), (0.8, 0.3)]]
    for f in range(5):
        for k in range(3):
            j_pos[1 + f * 3 + k] = dirs[f] * (0.035 + 0.018 * (k + 1))
    d = np.linalg.norm(v_template[None, :, :] - j_pos[:, None, :], axis=2)
    jr = np.exp(-((d / 0.01) ** 2))
    jr[jr < 1e-8] = 0.0
    for j in range(NUM_JOINTS):
        if jr[j].sum() < 1e-6:
            jr[j, np.argsort(d[j])[:8]] = 1.0
    w = np.exp(-((d.T / 0.02) ** 2))
    w[:, 0] += 0.05
    basis = np.stack([np.sin(3.1 * sphere @ rng.randn(3)) for _ in range(NUM_BETAS)], axis=-1)
    return dict(
        v_template=v_template,
        shapedirs=0.004 * basis[:, None, :] * (0.5 + sphere)[:, :, None],
        posedirs=0.002 * rng.randn(9 * NUM_POSE_JOINTS, NUM_VERTS * 3) / np.sqrt(NUM_VERTS),
        j_regressor=jr / jr.sum(axis=1, keepdims=True),
        lbs_weights=w / w.sum(axis=1, keepdims=True),
        faces=faces,
    )


def tensors(device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The hand as float32 tensors (int64 faces) on ``device``."""
    a = arrays(seed)
    out = {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in a.items() if k != "faces"}
    out["faces"] = torch.tensor(np.asarray(a["faces"], np.int64), device=device)
    return out
