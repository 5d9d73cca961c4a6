"""Image files and resizing without OpenCV (what the JAX data layer asks of cv2).

``imread`` decodes a PNG itself: the chunks are parsed here, the image data
inflated by ``zlib`` and the five row filters undone by the native library's
``png_unfilter`` (``csrc/data_kernels.cpp``; Average and Paeth depend on the
byte just decoded, so they run sequentially in C). 8-bit gray, RGB and
RGBA are read, and the result is what ``cv2.imread(path)`` returns: a BGR
HWC uint8 array (gray replicated, alpha dropped). A JPEG is handed to
cv2, imported for that file only; without cv2 it raises an error that names
the file and the missing decoder, and nothing is substituted.

``imwrite_png`` writes an RGB PNG from a BGR array (row filters cycling
through all five types unless others are given). ``resize_linear`` computes
``cv2.resize(img, (w, h))`` (INTER_LINEAR) on uint8 images bit for bit.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type (gray, RGB, RGBA) -> samples per pixel


def imread(path: str) -> np.ndarray:
    """The image at ``path`` as BGR HWC uint8 (``cv2.imread``'s result)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        return _decode_png(data, path)
    if data.startswith(_JPEG_MAGIC):
        return _decode_with_cv2(path, "JPEG")
    raise ValueError(f"{path}: not a PNG or JPEG file")


def _decode_with_cv2(path: str, kind: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as err:
        raise RuntimeError(
            f"{path}: decoding {kind} needs OpenCV (cv2), which is not installed; convert the images to PNG, "
            "which ihmr_tpu_torch decodes itself"
        ) from err
    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"{path}: cv2 could not decode this {kind} file")
    return img


def png_scanlines(data: bytes, path: str = "<png>") -> Tuple[int, int, int, bytes]:
    """A PNG file's bytes -> (height, width, samples per pixel, the inflated
    scanlines: a filter byte and width * samples bytes per row)."""
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, colour, _compression, _filter, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {colour}, interlace {interlace}; only 8-bit, "
            "non-interlaced gray, RGB and RGBA are read"
        )
    return height, width, _CHANNELS[colour], zlib.decompress(b"".join(idat))


def _decode_png(data: bytes, path: str) -> np.ndarray:
    from ihmr_tpu_torch.data.native import png_unfilter

    height, width, ch, scanlines = png_scanlines(data, path)
    px = png_unfilter(scanlines, height, width * ch, ch).reshape(height, width, ch)
    if ch == 1:  # gray: replicated into three channels
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) -> BGR, alpha dropped


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def imwrite_png(path: str, img: np.ndarray, filters: Optional[Sequence[int]] = None) -> None:
    """Write a BGR HWC uint8 image as an 8-bit RGB PNG. Row y takes filter
    type ``filters[y % len(filters)]`` (default: all five in turn, None,
    Sub, Up, Average, Paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"imwrite_png takes uint8 (H, W, 3) BGR images, got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    bpp = 3
    x = img[..., ::-1].reshape(height, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]  # the left neighbour
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # the byte above
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]  # above-left
    predictors = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c))
    kinds = np.resize(np.asarray(filters if filters is not None else range(5), np.int64), height)
    pred = np.choose(kinds[:, None], predictors)
    body = np.concatenate([kinds[:, None], (x - pred) & 0xFF], axis=1).astype(np.uint8)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))

    png = (
        _PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(body.tobytes()))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


@functools.lru_cache(maxsize=256)
def _linear_taps(src: int, dst: int, clamp: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's INTER_LINEAR taps along one axis: (first source index, its
    weight, the next index's weight), weights round((1 - f) * 2048) and
    round(f * 2048) from the float32 offset f of the half-pixel mapping
    (dst + 0.5) * scale - 0.5. With ``clamp`` (the x axis) an offset left of
    the first or right of the last pixel snaps to it with f = 0; the y axis
    keeps f and clamps only the row indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    taps = (s.astype(np.int32), w0, w1)
    for t in taps:
        t.setflags(write=False)  # cached: shared by every caller
    return taps


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (size = (width, height), INTER_LINEAR) on a
    uint8 (H, W[, C]) image, bit for bit: OpenCV's fixed-point path, 11-bit
    weights (``_linear_taps``), an integer horizontal pass, then the vertical
    pass of its vector code, (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >>
    16) + 2) >> 2; the passes run in the native library. An exact halving of
    both sides is OpenCV's area average, (sum of 4 + 2) >> 2."""
    from ihmr_tpu_torch.data.native import resize_linear_u8

    w, h = int(size[0]), int(size[1])
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8 images, got {img.dtype}")
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.copy()
    if W == 2 * w and H == 2 * h:
        x = img.astype(np.int32)
        s = x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    out = resize_linear_u8(img.reshape(H, W, -1), (w, h), _linear_taps(W, w, True), _linear_taps(H, h, False))
    return out.reshape((h, w) + img.shape[2:])
