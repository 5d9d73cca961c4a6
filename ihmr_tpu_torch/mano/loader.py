"""MANO assets (port of ihmr_tpu/mano/loader.py).

Two sources:

  * ``load_mano_model`` / ``load_mano_pair`` read the official
    ``MANO_{RIGHT,LEFT}.pkl`` files. They hold chumpy objects and scipy
    sparse matrices; a tolerant unpickler reads them without chumpy and
    everything becomes plain numpy. The known left-hand ``shapedirs`` bug
    is fixed as the reference fixes it: when the left and right x rows
    coincide, the left x row is negated.
  * ``synthetic_mano_model`` builds the deterministic synthetic hand with
    MANO's exact tensor shapes from the same numpy draws as the JAX
    package, so both packages hold bit-identical arrays for one seed.

Faces are Morton-sorted (``sort_faces_spatially``): the in-loop collision's
face stride ``faces[::2]`` relies on that order being a spatially uniform
sub-mesh, and the exact collision kernel's tile pruning on tiles being
spatially tight.
"""

from __future__ import annotations

import dataclasses
import io
import os.path as osp
import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.device import DeviceLike, resolve_device
from ihmr_tpu_torch.mano.model import (
    MANO_PARENTS,
    NUM_BETAS,
    NUM_FACES,
    NUM_JOINTS,
    NUM_POSE_JOINTS,
    NUM_VERTS,
    ManoModel,
)


class _Stub:
    """Placeholder for unpicklable classes (chumpy.Ch); keeps the raw state."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {"state": state})


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _Stub


def _to_numpy(obj) -> np.ndarray:
    if isinstance(obj, np.ndarray):
        return np.asarray(obj, np.float64)
    if hasattr(obj, "toarray"):  # scipy sparse
        return np.asarray(obj.toarray(), np.float64)
    for attr in ("r", "x", "v"):  # chumpy conventions
        if hasattr(obj, attr):
            return _to_numpy(getattr(obj, attr))
    if isinstance(obj, _Stub):
        for key in ("x", "r", "v", "a"):
            if key in obj.__dict__:
                return _to_numpy(obj.__dict__[key])
    return np.asarray(obj, np.float64)


def _load_raw_pkl(path: str) -> Dict:
    with open(path, "rb") as f:
        data = f.read()
    return _TolerantUnpickler(io.BytesIO(data), encoding="latin1").load()


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Interleave 10-bit ints with two zero bits (Morton encoding helper)."""
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v


def sort_faces_spatially(v_template: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Reorder faces by the Morton code of their rest-pose centroids."""
    v = np.asarray(v_template, np.float64)
    f = np.asarray(faces, np.int64)
    centroid = v[f].mean(axis=1)
    lo = centroid.min(0)
    span = np.maximum(centroid.max(0) - lo, 1e-9)
    q = np.clip(((centroid - lo) / span * 1023).astype(np.int64), 0, 1023)
    morton = (
        _spread_bits(q[:, 0])
        | (_spread_bits(q[:, 1]) << np.uint64(1))
        | (_spread_bits(q[:, 2]) << np.uint64(2))
    )
    return f[np.argsort(morton, kind="stable")]


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    golden = np.pi * (1.0 + 5.0**0.5)
    theta = golden * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], axis=1
    )


def _convex_hull_faces(points: np.ndarray) -> np.ndarray:
    from scipy.spatial import ConvexHull

    hull = ConvexHull(points)
    faces = hull.simplices.astype(np.int64)
    # orient faces outward (the hull is star-shaped about its centroid)
    centroid = points.mean(axis=0)
    tri = points[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    outward = np.einsum("fd,fd->f", normals, tri.mean(axis=1) - centroid) > 0
    faces[~outward] = faces[~outward][:, ::-1]
    return faces


def synthetic_mano_arrays(seed: int = 0) -> dict:
    """The synthetic right hand as float64/int64 numpy arrays.

    Geometry: a convex deformation of a Fibonacci sphere (its hull is a
    closed, outward-oriented mesh), five finger rays of joints, skinning
    weights falling off with distance to each joint, smooth random blend
    shapes. Faces are padded/truncated to 1538 and Morton-sorted."""
    rng = np.random.RandomState(seed)

    sphere = _fibonacci_sphere(NUM_VERTS)
    radii = 0.04 * (1.0 + 0.35 * sphere[:, 0] ** 2 + 0.2 * sphere[:, 1] ** 2)
    v_template = sphere * radii[:, None]
    v_template[:, 0] += 0.04  # "fingers" along +x, wrist near the origin

    faces = _convex_hull_faces(v_template)
    if faces.shape[0] >= NUM_FACES:
        faces = faces[:NUM_FACES]
    else:  # pad by repeating existing faces
        reps = np.resize(np.arange(faces.shape[0]), NUM_FACES - faces.shape[0])
        faces = np.concatenate([faces, faces[reps]], axis=0)
    faces = sort_faces_spatially(v_template, faces)

    j_pos = np.zeros((NUM_JOINTS, 3))
    finger_dirs = np.stack(
        [
            np.array([1.0, y, 0.15 * z]) / np.linalg.norm([1.0, y, 0.15 * z])
            for y, z in [(0.5, 1), (0.2, 0), (-0.4, -1), (-0.15, -0.5), (0.8, 0.3)]
        ]
    )
    for f in range(5):
        for k in range(3):
            j_pos[1 + f * 3 + k] = finger_dirs[f] * (0.035 + 0.018 * (k + 1))

    # J_regressor: soft-assign each joint to its nearest vertices
    d = np.linalg.norm(v_template[None, :, :] - j_pos[:, None, :], axis=2)  # (16, 778)
    jr = np.exp(-((d / 0.01) ** 2))
    jr[jr < 1e-8] = 0.0
    for j in range(NUM_JOINTS):
        if jr[j].sum() < 1e-6:
            nearest = np.argsort(d[j])[:8]
            jr[j, nearest] = 1.0
    j_regressor = jr / jr.sum(axis=1, keepdims=True)

    w = np.exp(-((d.T / 0.02) ** 2))  # (778, 16)
    w[:, 0] += 0.05  # wrist base support
    lbs_weights = w / w.sum(axis=1, keepdims=True)

    basis = np.stack([np.sin(3.1 * sphere @ rng.randn(3)) for _ in range(NUM_BETAS)], axis=-1)
    shapedirs = 0.004 * basis[:, None, :] * (0.5 + sphere)[:, :, None]
    posedirs = 0.002 * rng.randn(9 * NUM_POSE_JOINTS, NUM_VERTS * 3) / np.sqrt(NUM_VERTS)
    return dict(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs_weights,
        faces=faces,
    )


def model_from_arrays(arrays: dict, device: DeviceLike = None, is_rhand: bool = True) -> ManoModel:
    """ManoModel on ``device`` from numpy arrays (float32 tensors, int64 faces)."""
    dev = resolve_device(device)

    def f32(name):
        return torch.tensor(np.asarray(arrays[name], np.float32), device=dev)

    return ManoModel(
        v_template=f32("v_template"),
        shapedirs=f32("shapedirs"),
        posedirs=f32("posedirs"),
        j_regressor=f32("j_regressor"),
        lbs_weights=f32("lbs_weights"),
        faces=torch.tensor(np.asarray(arrays["faces"], np.int64), device=dev),
        is_rhand=is_rhand,
    )


def synthetic_mano_model(seed: int = 0, device: DeviceLike = None) -> ManoModel:
    """Deterministic synthetic right hand with MANO's exact tensor shapes."""
    return model_from_arrays(synthetic_mano_arrays(seed), device)


def load_mano_model(path: str, is_rhand: bool, device: DeviceLike = None) -> Tuple[ManoModel, np.ndarray]:
    """One ``MANO_*.pkl`` -> (model on ``device``, hands_mean (45,) float64).
    Faces are Morton-sorted; a kinematic tree other than MANO's raises."""
    raw = _load_raw_pkl(path)
    v_template = _to_numpy(raw["v_template"]).reshape(NUM_VERTS, 3)
    faces = sort_faces_spatially(v_template, np.asarray(_to_numpy(raw["f"]), np.int64).reshape(-1, 3))
    arrays = dict(
        v_template=v_template,
        shapedirs=_to_numpy(raw["shapedirs"])[..., :NUM_BETAS].reshape(NUM_VERTS, 3, NUM_BETAS),
        posedirs=_to_numpy(raw["posedirs"]).reshape(NUM_VERTS * 3, 9 * NUM_POSE_JOINTS).T,
        j_regressor=_to_numpy(raw["J_regressor"]).reshape(NUM_JOINTS, NUM_VERTS),
        lbs_weights=_to_numpy(raw["weights"]).reshape(NUM_VERTS, NUM_JOINTS),
        faces=faces,
    )
    hands_mean = _to_numpy(raw.get("hands_mean", np.zeros(3 * NUM_POSE_JOINTS))).reshape(-1)
    kintree = raw.get("kintree_table")
    if kintree is not None:
        parents = np.asarray(_to_numpy(kintree), np.int64)[0].astype(np.int32)
        parents[0] = -1
        if not np.array_equal(parents, MANO_PARENTS):
            raise ValueError(f"{path}: unexpected MANO kinematic tree {parents.tolist()}")
    return model_from_arrays(arrays, device, is_rhand=is_rhand), hands_mean.astype(np.float64)


def load_mano_pair(model_root: str, device: DeviceLike = None) -> Dict[str, Tuple[ManoModel, np.ndarray]]:
    """Both hands from ``model_root``, with the left-shapedirs x-flip fix:
    {'right': (model, hands_mean), 'left': (model, hands_mean)}."""
    right, right_mean = load_mano_model(osp.join(model_root, "MANO_RIGHT.pkl"), True, device)
    left, left_mean = load_mano_model(osp.join(model_root, "MANO_LEFT.pkl"), False, device)
    shape_diff = float((left.shapedirs[:, 0, :] - right.shapedirs[:, 0, :]).abs().mean())
    if shape_diff < 1e-7:  # the well-known left-hand MANO bug
        sign = torch.tensor([-1.0, 1.0, 1.0], dtype=left.shapedirs.dtype, device=left.device)
        left = dataclasses.replace(left, shapedirs=left.shapedirs * sign[None, :, None])
    return {"right": (right, right_mean), "left": (left, left_mean)}


def mirror_mano_model(right: ManoModel) -> ManoModel:
    """The exact x-mirrored (left) model of a right-hand model.

    With M = diag(-1, 1, 1) and theta_L = flip_yz(theta_R), R_L = M R_R M:
    v_template / shapedirs flip their x rows, posedirs rows pick up the sign
    s_l * M_cc (s_l = -1 where the rotation entry (i, j) has exactly one
    index 0), J_regressor / lbs_weights stay, and the face winding reverses."""
    M = torch.tensor([-1.0, 1.0, 1.0], dtype=right.v_template.dtype, device=right.device)
    sign9 = np.array([[1 if (i == 0) == (j == 0) else -1 for j in range(3)] for i in range(3)])
    s_l = torch.as_tensor(
        np.tile(sign9.reshape(9), NUM_POSE_JOINTS), dtype=right.posedirs.dtype, device=right.device
    )
    pd = right.posedirs.reshape(9 * NUM_POSE_JOINTS, NUM_VERTS, 3)
    pd_left = pd * s_l[:, None, None] * M[None, None, :]
    return ManoModel(
        v_template=right.v_template * M,
        shapedirs=right.shapedirs * M[None, :, None],
        posedirs=pd_left.reshape(9 * NUM_POSE_JOINTS, NUM_VERTS * 3),
        j_regressor=right.j_regressor,
        lbs_weights=right.lbs_weights,
        faces=right.faces.flip(-1),
        is_rhand=False,
    )
