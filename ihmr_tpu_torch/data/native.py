"""ctypes bindings of the host data kernels (port of ihmr_tpu/native/__init__.py).

``csrc/data_kernels.cpp`` is compiled by g++ at first use
(``build.load_host_library``). Where the JAX package falls back to its
NumPy/cv2 path when the build fails, the port raises: every caller here is
on the data path and must get the native result.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_I32P = ctypes.POINTER(ctypes.c_int)

# symbol -> (restype, argtypes)
_SIGNATURES = {
    "letterbox_normalize": (ctypes.c_float, [_U8P, _I, _I, _I, _I, _F32P]),
    "letterbox_normalize_batch": (None, [_U8P, _I, _I, _I, _I, _I, _F32P, _F32P]),
    "normalize_batch": (None, [_U8P, _I, _I, _I, _F32P]),
    "png_unfilter": (ctypes.c_int, [_U8P, _I, _I, _I, _U8P]),
    "resize_linear_u8": (None, [_U8P, _I, _I, _I, _U8P, _I, _I] + [_I32P] * 6),
}
_functions = {}


def _fn(symbol: str):
    """The library's ``symbol`` with its ctypes signature set once; builds
    and loads the library on first use (raises if that fails)."""
    if symbol not in _functions:
        from ihmr_tpu_torch.build import load_host_library

        fn = getattr(load_host_library("data_kernels"), symbol)
        fn.restype, fn.argtypes = _SIGNATURES[symbol]
        _functions[symbol] = fn
    return _functions[symbol]


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def letterbox_normalize(img: np.ndarray, final_size: int = 224) -> Tuple[np.ndarray, float]:
    """uint8 BGR HWC -> (normalized float32 (S, S, 3) in [-1, 1], channel
    order kept; the resize ratio, a float32 widened to float)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c < 3:
        raise ValueError(f"letterbox_normalize reads 3 channels, got {img.shape}")
    out = np.empty((final_size, final_size, 3), np.float32)
    ratio = _fn("letterbox_normalize")(_u8ptr(img), h, w, c, final_size, _f32ptr(out))
    return out, float(ratio)


def letterbox_normalize_batch(imgs: np.ndarray, final_size: int = 224) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 -> ((B, S, S, 3) float32 in [-1, 1], (B,) float32 ratios)."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    b, h, w, c = imgs.shape
    if c < 3:
        raise ValueError(f"letterbox_normalize_batch reads 3 channels, got {imgs.shape}")
    out = np.empty((b, final_size, final_size, 3), np.float32)
    ratios = np.empty(b, np.float32)
    _fn("letterbox_normalize_batch")(_u8ptr(imgs), b, h, w, c, final_size, _f32ptr(out), _f32ptr(ratios))
    return out, ratios


def normalize_batch(imgs: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, H, W, 3) float32 in [-1, 1], channel order kept."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    b, h, w, c = imgs.shape
    if c != 3:
        raise ValueError(f"normalize_batch takes 3 channels, got {imgs.shape}")
    out = np.empty((b, h, w, 3), np.float32)
    _fn("normalize_batch")(_u8ptr(imgs), b, h, w, _f32ptr(out))
    return out


def png_unfilter(data: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Decompressed PNG scanlines (a filter byte + ``row_bytes`` per row) ->
    (height, row_bytes) uint8 with the row filters undone."""
    src = np.frombuffer(data, np.uint8)
    if src.size != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {src.size} bytes, expected {height * (row_bytes + 1)}")
    src = np.ascontiguousarray(src)
    out = np.empty((height, row_bytes), np.uint8)
    bad = _fn("png_unfilter")(_u8ptr(src), height, row_bytes, bpp, _u8ptr(out))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type {src[(bad - 1) * (row_bytes + 1)]}")
    return out


def resize_linear_u8(img: np.ndarray, size, x_taps, y_taps) -> np.ndarray:
    """The integer passes of OpenCV's INTER_LINEAR on a uint8 (H, W, C)
    image -> (h, w, C) uint8, given the taps of each axis (first source
    index, weight of it, weight of the next; int32 arrays of w and h)."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W, C = img.shape
    w, h = size
    taps = [np.ascontiguousarray(t, np.int32) for t in (*x_taps, *y_taps)]
    if any(t.shape != (w,) for t in taps[:3]) or any(t.shape != (h,) for t in taps[3:]):
        raise ValueError(f"resize taps must have {w} (x) and {h} (y) entries")
    if taps[0].min(initial=0) < 0 or taps[0].max(initial=0) >= W:
        raise ValueError(f"x taps outside the {W} source columns")
    out = np.empty((h, w, C), np.uint8)
    _fn("resize_linear_u8")(
        _u8ptr(img), H, W, C, _u8ptr(out), h, w, *(t.ctypes.data_as(_I32P) for t in taps)
    )
    return out
