"""Host-side file IO helpers (a copy of ihmr_tpu/utils/io_utils.py).

The reference's external ``ry_utils`` package as the port uses it: pickle
load/save, directories, recursive file listing, obj mesh export and import.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import shutil
from typing import Any, List

import numpy as np


def load_pkl(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pkl(path: str, obj: Any, protocol: int = pickle.HIGHEST_PROTOCOL) -> None:
    build_dir(osp.dirname(path) or ".")
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=protocol)


def build_dir(path: str) -> str:
    """mkdir -p."""
    if path:
        os.makedirs(path, exist_ok=True)
    return path


def renew_dir(path: str) -> str:
    """rm -rf + mkdir."""
    if osp.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def make_subdir(file_path: str) -> None:
    """Create the directory that will contain ``file_path``."""
    build_dir(osp.dirname(file_path))


def get_all_files(root: str, suffix: str = "", path_type: str = "full") -> List[str]:
    """Recursively list files under ``root`` ending with ``suffix``, sorted.

    ``path_type``: 'full' returns root-joined paths, 'name' basenames,
    anything else paths relative to root.
    """
    results = []
    for subdir, _dirs, files in os.walk(root):
        for name in sorted(files):
            if suffix and not name.endswith(suffix):
                continue
            full = osp.join(subdir, name)
            if path_type == "full":
                results.append(full)
            elif path_type == "name":
                results.append(name)
            else:
                results.append(osp.relpath(full, root))
    return sorted(results)


def save_mesh_to_obj(path: str, verts: np.ndarray, faces: np.ndarray | None = None) -> None:
    """Write a Wavefront .obj (1-indexed faces)."""
    make_subdir(path)
    verts = np.asarray(verts)
    lines: List[str] = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    if faces is not None:
        faces = np.asarray(faces).astype(np.int64)
        lines += [f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}" for f in faces]
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def load_obj(path: str):
    verts, faces = [], []
    with open(path) as fp:
        for line in fp:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)
