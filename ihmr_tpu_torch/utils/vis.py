"""Host-side visualization: weak-perspective mesh rendering + keypoints (port
of ihmr_tpu/utils/vis.py).

A NumPy z-buffer rasterizer in place of the reference's OpenDR renderer, the
JAX package's arithmetic in the same order, so every array is equal to its
bit for bit. Camera: cam = (s, tx, ty), pixel = (s * (x + t) + 1) / 2 *
size, depth the orthographic z. Rendering stays on the host, as in the JAX
package. Where it calls OpenCV the port calls its own counterparts:
``data.cv_ops.resize_linear_float`` for a float background of another size
(within 1e-4 of ``cv2.resize``), ``data.image_io.resize_linear`` and
``data.cv_ops.fill_circle_r2`` for the keypoint image (bit for bit).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ihmr_tpu_torch.data import cv_ops, image_io

COLORS: Dict[str, np.ndarray] = {
    "light_green": np.array([0.6, 0.9, 0.6]),
    "light_blue": np.array([0.65, 0.75, 0.95]),
    "pink": np.array([0.95, 0.7, 0.75]),
    "red": np.array([1.0, 0.2, 0.2]),
    "green": np.array([0.2, 0.9, 0.2]),
}


def recover_img(img: np.ndarray) -> np.ndarray:
    """Normalized float RGB HWC [-1,1] -> uint8 RGB."""
    out = (np.asarray(img) * 0.5 + 0.5) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def project_verts(verts: np.ndarray, cam: np.ndarray, size: int) -> np.ndarray:
    """(V, 3) + (3,) -> (V, 3) pixel x, y + z depth."""
    s, tx, ty = float(cam[0]), float(cam[1]), float(cam[2])
    xy = (verts[:, :2] + np.array([tx, ty])) * s
    pix = (xy + 1.0) * 0.5 * size
    return np.concatenate([pix, verts[:, 2:3]], axis=1)


def rasterize(
    verts_pix: np.ndarray,  # (V, 3) pixel x, y, depth z
    faces: np.ndarray,  # (F, 3)
    size: int,
    base_color: np.ndarray,  # (3,) or (V, 3)
    light_dir=(0.3, 0.3, -1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (rgb float (S,S,3), mask bool (S,S)). Flat-shaded float64
    z-buffer, faces painted far to near, a pixel taken by a strictly nearer
    depth."""
    img = np.zeros((size, size, 3), np.float32)
    zbuf = np.full((size, size), np.inf, np.float32)
    mask = np.zeros((size, size), bool)

    v = np.asarray(verts_pix, np.float64)
    f = np.asarray(faces, np.int64)
    tri = v[f]  # (F, 3, 3)
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)

    vcolor = np.broadcast_to(np.asarray(base_color, np.float64), (v.shape[0], 3))

    # backface + normal shading (screen space; camera looks down -z)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    n_norm = np.linalg.norm(n, axis=1, keepdims=True)
    n_unit = n / np.maximum(n_norm, 1e-12)
    shade = np.clip(-n_unit @ light, 0.15, 1.0)

    order = np.argsort(-tri[:, :, 2].mean(axis=1))  # far to near (painter prep)
    for fi in order:
        t = tri[fi]
        x0, y0 = int(np.floor(t[:, 0].min())), int(np.floor(t[:, 1].min()))
        x1, y1 = int(np.ceil(t[:, 0].max())), int(np.ceil(t[:, 1].max()))
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, size - 1), min(y1, size - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        # barycentric coords
        d = (t[1, 1] - t[2, 1]) * (t[0, 0] - t[2, 0]) + (t[2, 0] - t[1, 0]) * (t[0, 1] - t[2, 1])
        if abs(d) < 1e-12:
            continue
        w0 = ((t[1, 1] - t[2, 1]) * (xs - t[2, 0]) + (t[2, 0] - t[1, 0]) * (ys - t[2, 1])) / d
        w1 = ((t[2, 1] - t[0, 1]) * (xs - t[2, 0]) + (t[0, 0] - t[2, 0]) * (ys - t[2, 1])) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = w0 * t[0, 2] + w1 * t[1, 2] + w2 * t[2, 2]
        yy, xx = ys[inside], xs[inside]
        zz = z[inside]
        closer = zz < zbuf[yy, xx]
        yy, xx, zz = yy[closer], xx[closer], zz[closer]
        if yy.size == 0:
            continue
        zbuf[yy, xx] = zz
        col = vcolor[f[fi]].mean(axis=0) * shade[fi]
        img[yy, xx] = col
        mask[yy, xx] = True
    return img, mask


def _background(background: Optional[np.ndarray], size: int) -> np.ndarray:
    """The float32 copy of a uint8 RGB background (black when None), resized
    to (size, size) as ``cv2.resize`` resizes a float image."""
    if background is None:
        background = np.zeros((size, size, 3), np.uint8)
    out = np.asarray(background, np.float32).copy()
    if out.shape[:2] != (size, size):
        out = cv_ops.resize_linear_float(out, (size, size))
    return out


def render_mesh_to_image(
    size: int,
    background: Optional[np.ndarray],  # uint8 RGB HWC or None
    cam: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    color: str | np.ndarray = "light_green",
    alpha: float = 1.0,
) -> np.ndarray:
    """Overlay one mesh on an image."""
    base = COLORS[color] if isinstance(color, str) else np.asarray(color)
    pix = project_verts(np.asarray(verts), np.asarray(cam), size)
    rgb, mask = rasterize(pix, faces, size, base)
    out = _background(background, size)
    out[mask] = (1 - alpha) * out[mask] + alpha * rgb[mask] * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def render_together(
    verts_list: Sequence[np.ndarray],
    faces_list: Sequence[np.ndarray],
    color_list: Sequence[np.ndarray],
    cam: np.ndarray,
    size: int,
    background: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Multiple meshes, one z-buffer."""
    verts = np.concatenate(list(verts_list), axis=0)
    offset = 0
    faces, colors = [], []
    for v, f, c in zip(verts_list, faces_list, color_list):
        faces.append(np.asarray(f) + offset)
        colors.append(np.broadcast_to(np.asarray(c).reshape(1, 3), (v.shape[0], 3)))
        offset += v.shape[0]
    faces = np.concatenate(faces, axis=0)
    vcolors = np.concatenate(colors, axis=0)
    pix = project_verts(verts, np.asarray(cam), size)
    rgb, mask = rasterize(pix, faces, size, vcolors)
    out = _background(background, size)
    out[mask] = rgb[mask] * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_keypoints(
    img_normalized: np.ndarray,
    keypoints: np.ndarray,  # (J, 2) in [-1, 1]
    weights: np.ndarray,  # (J, 1)
    color: str = "red",
    size: int = 224,
) -> np.ndarray:
    """Dots (radius 2) for valid keypoints on the de-normalized image."""
    img = recover_img(img_normalized).copy()
    if img.shape[:2] != (size, size):
        img = image_io.resize_linear(img, (size, size))
    col = tuple(int(c * 255) for c in COLORS[color])
    for (x, y), w in zip(np.asarray(keypoints), np.asarray(weights).reshape(-1)):
        if w > 0:
            px, py = int((x + 1) * 0.5 * size), int((y + 1) * 0.5 * size)
            if 0 <= px < size and 0 <= py < size:
                cv_ops.fill_circle_r2(img, (px, py), col)
    return img
