"""OpenCV's image operations that the training augmentations use, without OpenCV.

Each function returns what the named cv2 call returns on uint8 images; the
pixel loops run in the native library (``csrc/image_ops.cpp``, built with
``-ffp-contract=off``), called through ctypes, which releases the GIL:

  * ``get_rotation_matrix_2d``: ``cv2.getRotationMatrix2D`` (float64, the
    centre rounded to float32 as OpenCV's ``Point2f`` holds it);
  * ``warp_affine_linear``: ``cv2.warpAffine(img, M, dsize)`` with
    INTER_LINEAR and a constant border of 0, OpenCV 5's float32 path bit for
    bit (the map inverted in float64 as OpenCV inverts it);
  * ``bgr_to_hsv`` / ``hsv_to_bgr``: ``cv2.cvtColor`` with
    COLOR_BGR2HSV / COLOR_HSV2BGR (hue in [0, 180)), bit for bit;
  * ``filter2d``: ``cv2.filter2D(img, -1, kernel)`` (correlation, anchor at
    the centre, BORDER_REFLECT_101) as a direct float32 sum. OpenCV takes a
    DFT for large kernels, so its result and this one differ by 1 on a few
    pixels in 10^5.

Two more, in numpy, for the mesh renderer (utils/vis.py):

  * ``fill_circle_r2``: ``cv2.circle(img, center, 2, color, -1)``, the
    13-pixel diamond OpenCV fills at radius 2, clipped at the border;
  * ``resize_linear_float``: ``cv2.resize`` (INTER_LINEAR) on float32
    images, OpenCV's float path (float32 weights of the half-pixel map, the
    x offset clamped at both ends, the y offset's rows clamped; an exact
    halving of both sides is the area average), within 1e-4 of it on
    sources of 2 pixels a side or more (its vector code fuses multiply-adds;
    measured 4.6e-5 at most on values in 0..255).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np

from ihmr_tpu_torch.data.native import function


def _u8_image(img: np.ndarray, name: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or min(img.shape[:2]) < 1:
        raise ValueError(f"{name} takes a uint8 (H, W[, C]) image, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def _hwc3(img: np.ndarray, name: str) -> np.ndarray:
    img = _u8_image(img, name)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{name} takes 3 channels, got {img.shape}")
    return img


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def get_rotation_matrix_2d(center: Sequence[float], angle_deg: float, scale: float) -> np.ndarray:
    """The (2, 3) float64 rotation about ``center`` (x, y) by ``angle_deg``
    counter-clockwise, scaled by ``scale``."""
    angle = angle_deg * (math.pi / 180.0)
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array(
        [[alpha, beta, (1.0 - alpha) * cx - beta * cy], [-beta, alpha, beta * cx + (1.0 - alpha) * cy]], np.float64
    )


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse of a (2, 3) affine map, in float64 as cv2.invertAffineTransform
    (and warpAffine without WARP_INVERSE_MAP) computes it."""
    m00, m01, m02, m10, m11, m12 = (float(v) for v in np.asarray(m, np.float64).reshape(6))
    d = m00 * m11 - m01 * m10
    d = 1.0 / d if d != 0.0 else 0.0
    a11, a22 = m11 * d, m00 * d
    a01, a10 = m01 * -d, m10 * -d
    return np.array([[a11, a01, -a11 * m02 - a01 * m12], [a10, a22, -a10 * m02 - a22 * m12]], np.float64)


def warp_affine_linear(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=cv2.INTER_LINEAR)`` on uint8
    (dsize = (width, height)); pixels mapped outside the source are 0."""
    img = _u8_image(img, "warp_affine_linear")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw < 1 or dh < 1:
        raise ValueError(f"warp_affine_linear: dsize {dsize} is empty")
    inv = np.ascontiguousarray(invert_affine(m).reshape(6))
    out = np.empty((dh, dw) + img.shape[2:], np.uint8)
    function("warp_affine_linear_u8")(_ptr(img, ctypes.c_uint8), h, w, c, _ptr(inv, ctypes.c_double),
                                      _ptr(out, ctypes.c_uint8), dh, dw)
    return out


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on a uint8 (H, W, 3) image."""
    img = _hwc3(img, "bgr_to_hsv")
    out = np.empty_like(img)
    function("bgr_to_hsv_u8")(_ptr(img, ctypes.c_uint8), img.shape[0] * img.shape[1], _ptr(out, ctypes.c_uint8))
    return out


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on a uint8 (H, W, 3) image."""
    img = _hwc3(img, "hsv_to_bgr")
    out = np.empty_like(img)
    function("hsv_to_bgr_u8")(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1], _ptr(out, ctypes.c_uint8))
    return out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` on uint8: the correlation with the
    float32 ``kernel`` anchored at its centre, borders reflected (101),
    rounded half to even and saturated."""
    img = _u8_image(img, "filter2d")
    kernel = np.ascontiguousarray(kernel, np.float32)
    if kernel.ndim != 2 or kernel.size == 0:
        raise ValueError(f"filter2d takes a 2D kernel, got {kernel.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty_like(img)
    function("filter2d_u8")(_ptr(img, ctypes.c_uint8), h, w, c, _ptr(kernel, ctypes.c_float), kernel.shape[0],
                            kernel.shape[1], _ptr(out, ctypes.c_uint8))
    return out


# the pixels cv2.circle fills at radius 2 (thickness -1): |dx| + |dy| <= 2
_DISC_R2 = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if abs(dx) + abs(dy) <= 2]


def fill_circle_r2(img: np.ndarray, center: Tuple[int, int], color: Sequence[int]) -> None:
    """``cv2.circle(img, center, 2, color, -1)`` in place on an (H, W, C)
    uint8 image; ``center`` is (x, y)."""
    h, w = img.shape[:2]
    x, y = int(center[0]), int(center[1])
    for dy, dx in _DISC_R2:
        if 0 <= y + dy < h and 0 <= x + dx < w:
            img[y + dy, x + dx] = color


def _float_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index, weight of the next) of OpenCV's float
    INTER_LINEAR along one axis, the offset unclamped: the map in float64,
    its fraction rounded to float32."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def resize_linear_float(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (size = (width, height), INTER_LINEAR) on a
    float32 (H, W[, C]) image, within 1e-4."""
    img = np.asarray(img, np.float32)
    w, h = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.copy()
    if W == 2 * w and H == 2 * h:
        return ((img[0::2, 0::2] + img[0::2, 1::2]) + (img[1::2, 0::2] + img[1::2, 1::2])) * np.float32(0.25)
    sx, fx = _float_taps(W, w)
    edge = (sx < 0) | (sx >= W - 1)  # snapped to the first or last column, weight 0
    fx[edge] = 0.0
    sx = np.clip(sx, 0, W - 1)
    x1 = np.minimum(sx + 1, W - 1)
    ax = fx.reshape((1, w) + (1,) * (img.ndim - 2))
    rows = img[:, sx] * (np.float32(1.0) - ax) + img[:, x1] * ax
    sy, fy = _float_taps(H, h)
    y0, y1 = np.clip(sy, 0, H - 1), np.clip(sy + 1, 0, H - 1)
    by = fy.reshape((h,) + (1,) * (img.ndim - 1))
    return rows[y0] * (np.float32(1.0) - by) + rows[y1] * by
