"""ctypes bindings of the host data kernels (port of ihmr_tpu/native/__init__.py).

``csrc/data_kernels.cpp`` (letterbox, PNG row filters, resize),
``csrc/image_ops.cpp`` (OpenCV's warp, HSV conversions and filter2D, called
by ``cv_ops.py``) and ``csrc/jpeg_decode.cpp`` (the JPEG decoder's entropy
decoding and pixel stages, called by ``image_io.py``) are compiled by g++ at
first use (``build.load_host_library``). Where the JAX package falls back to
its NumPy/cv2 path when the build fails, the port raises: every caller here
is on the data path and must get the native result. ctypes releases the GIL
for the length of each call.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int
_I32P = ctypes.POINTER(ctypes.c_int)
_I16P = ctypes.POINTER(ctypes.c_int16)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_L = ctypes.c_long

# symbol -> (library, restype, argtypes)
_SIGNATURES = {
    "letterbox_normalize": ("data_kernels", ctypes.c_float, [_U8P, _I, _I, _I, _I, _F32P]),
    "letterbox_normalize_batch": ("data_kernels", None, [_U8P, _I, _I, _I, _I, _I, _F32P, _F32P]),
    "normalize_batch": ("data_kernels", None, [_U8P, _I, _I, _I, _F32P]),
    "png_unfilter": ("data_kernels", ctypes.c_int, [_U8P, _I, _I, _I, _U8P]),
    "resize_linear_u8": ("data_kernels", None, [_U8P, _I, _I, _I, _U8P, _I, _I] + [_I32P] * 6),
    "warp_affine_linear_u8": ("image_ops", None, [_U8P, _I, _I, _I, _F64P, _U8P, _I, _I]),
    "bgr_to_hsv_u8": ("image_ops", None, [_U8P, _L, _U8P]),
    "hsv_to_bgr_u8": ("image_ops", None, [_U8P, _I, _I, _U8P]),
    "filter2d_u8": ("image_ops", None, [_U8P, _I, _I, _I, _F32P, _I, _I, _U8P]),
    "jpeg_decode_scan": ("jpeg_decode", _L, [_U8P, _L, _L, _I, _I32P, _I64P, _U8P, _I, _I, _I, _I16P]),
    "jpeg_finish": ("jpeg_decode", _I, [_I16P, _I, _I32P, _I64P, _U16P, _I, _I, _I, _I, _U8P]),
}
_functions = {}


def function(symbol: str):
    """The host library's ``symbol`` with its ctypes signature set once;
    builds and loads the library on first use (raises if that fails)."""
    if symbol not in _functions:
        from ihmr_tpu_torch.build import load_host_library

        library, restype, argtypes = _SIGNATURES[symbol]
        fn = getattr(load_host_library(library), symbol)
        fn.restype, fn.argtypes = restype, argtypes
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
    ratio = function("letterbox_normalize")(_u8ptr(img), h, w, c, final_size, _f32ptr(out))
    return out, float(ratio)


def letterbox_normalize_batch(imgs: np.ndarray, final_size: int = 224) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 -> ((B, S, S, 3) float32 in [-1, 1], (B,) float32 ratios)."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    b, h, w, c = imgs.shape
    if c < 3:
        raise ValueError(f"letterbox_normalize_batch reads 3 channels, got {imgs.shape}")
    out = np.empty((b, final_size, final_size, 3), np.float32)
    ratios = np.empty(b, np.float32)
    function("letterbox_normalize_batch")(_u8ptr(imgs), b, h, w, c, final_size, _f32ptr(out), _f32ptr(ratios))
    return out, ratios


def normalize_batch(imgs: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, H, W, 3) float32 in [-1, 1], channel order kept."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    b, h, w, c = imgs.shape
    if c != 3:
        raise ValueError(f"normalize_batch takes 3 channels, got {imgs.shape}")
    out = np.empty((b, h, w, 3), np.float32)
    function("normalize_batch")(_u8ptr(imgs), b, h, w, _f32ptr(out))
    return out


def png_unfilter(data: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Decompressed PNG scanlines (a filter byte + ``row_bytes`` per row) ->
    (height, row_bytes) uint8 with the row filters undone."""
    src = np.frombuffer(data, np.uint8)
    if src.size != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {src.size} bytes, expected {height * (row_bytes + 1)}")
    src = np.ascontiguousarray(src)
    out = np.empty((height, row_bytes), np.uint8)
    bad = function("png_unfilter")(_u8ptr(src), height, row_bytes, bpp, _u8ptr(out))
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
    function("resize_linear_u8")(
        _u8ptr(img), H, W, C, _u8ptr(out), h, w, *(t.ctypes.data_as(_I32P) for t in taps)
    )
    return out


def jpeg_decode_scan(data: np.ndarray, pos: int, comps: np.ndarray, offsets: np.ndarray, tables: np.ndarray,
                     mcus_x: int, mcus_y: int, restart: int, coefs: np.ndarray) -> int:
    """Entropy-decode one JPEG scan from ``data[pos:]`` (uint8) into ``coefs``
    (int16, every component's blocks in natural order): ``comps`` (ns, 7)
    int32 rows (frame component, DC table, AC table, h, v, blocks per row,
    0), ``offsets`` (ns,) int64 each component's first coefficient,
    ``tables`` (8, 272) uint8 Huffman specs (DC 0-3, AC 0-3). Returns the
    position after the scan's data, -1 for an empty table."""
    if coefs.dtype != np.int16 or not coefs.flags.c_contiguous:
        raise ValueError("jpeg_decode_scan writes into a contiguous int16 array")
    comps = np.ascontiguousarray(comps, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    tables = np.ascontiguousarray(tables, np.uint8)
    data = np.ascontiguousarray(data, np.uint8)
    if tables.shape != (8, 272) or comps.shape != (len(offsets), 7) or not 1 <= len(offsets) <= 4:
        raise ValueError(f"jpeg_decode_scan: tables {tables.shape}, comps {comps.shape}, offsets {offsets.shape}")
    blocks = [o + 64 * c[5] * mcus_y * (1 if len(offsets) == 1 else c[4]) for o, c in zip(offsets, comps)]
    if max(blocks) > coefs.size or not 0 <= pos <= data.size:
        raise ValueError("jpeg_decode_scan: the scan's blocks run past the coefficient buffer")
    return function("jpeg_decode_scan")(
        _u8ptr(data), data.size, pos, len(offsets), comps.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I64P),
        _u8ptr(tables), mcus_x, mcus_y, restart, coefs.ctypes.data_as(_I16P),
    )


def jpeg_finish(coefs: np.ndarray, comps: np.ndarray, offsets: np.ndarray, quant: np.ndarray, hmax: int, vmax: int,
                out: np.ndarray) -> int:
    """The decoded coefficients -> ``out`` (H, W, 3) uint8 BGR: the inverse
    DCT with ``quant`` (ncomp, 64) uint16 in natural order, the upsampling of
    each component (``comps`` (ncomp, 4) int32 rows h, v, blocks per row,
    block rows) and the colour conversion. Returns 0, or 1 for sampling
    factors that are not integer ratios."""
    comps = np.ascontiguousarray(comps, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    quant = np.ascontiguousarray(quant, np.uint16)
    n = len(comps)
    if n not in (1, 3) or comps.shape != (n, 4) or quant.shape != (n, 64) or offsets.shape != (n,):
        raise ValueError(f"jpeg_finish: comps {comps.shape}, quant {quant.shape}, offsets {offsets.shape}")
    if out.dtype != np.uint8 or out.ndim != 3 or out.shape[2] != 3 or not out.flags.c_contiguous:
        raise ValueError(f"jpeg_finish writes a contiguous (H, W, 3) uint8 array, got {out.dtype} {out.shape}")
    if coefs.dtype != np.int16 or max(o + 64 * c[2] * c[3] for o, c in zip(offsets, comps)) > coefs.size:
        raise ValueError("jpeg_finish: the components' blocks run past the coefficient buffer")
    height, width = out.shape[:2]
    return function("jpeg_finish")(
        coefs.ctypes.data_as(_I16P), n, comps.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I64P),
        quant.ctypes.data_as(_U16P), width, height, hmax, vmax, _u8ptr(out),
    )
