"""Image files and resizing without OpenCV (what the JAX data layer asks of cv2).

``imread`` returns what ``cv2.imread(path)`` returns, a BGR HWC uint8 array,
byte for byte, from the port's own decoders:

  * PNG: the chunks are parsed here, the image data inflated by ``zlib`` and
    the five row filters undone by the native library's ``png_unfilter``
    (``csrc/data_kernels.cpp``; Average and Paeth depend on the byte just
    decoded, so they run sequentially in C). 8-bit gray, RGB and RGBA are
    read (gray replicated, alpha dropped).
  * JPEG: baseline and extended sequential Huffman-coded 8-bit files with
    one (gray, replicated) or three (YCbCr) components. The markers are
    parsed here (SOI, APPn, DQT, SOF0/SOF1, DHT, DRI, SOS, EOI); the entropy
    decoding, the inverse DCT, the upsampling and the colour conversion run
    in ``csrc/jpeg_decode.cpp`` with libjpeg-turbo's default arithmetic
    (cv2's decoder): the islow IDCT, fancy upsampling, table-driven YCbCr.
    The EXIF Orientation tag of an APP1 segment is applied as cv2 applies
    it. Progressive, arithmetic-coded, lossless and hierarchical files,
    12-bit samples, CMYK or RGB-coded (Adobe) files and sampling factors
    that are not integer ratios raise, naming the file and the mode.

Nothing falls back to another decoder.

``imwrite_png`` writes an RGB PNG from a BGR array (row filters cycling
through all five types unless others are given). ``encode_jpeg`` /
``imwrite_jpeg`` write the bytes ``cv2.imencode(".jpg")`` / ``cv2.imwrite``
write for a BGR array with their defaults (quality 95, 4:2:0, libjpeg-turbo's
islow DCT and standard tables; ``csrc/jpeg_encode.cpp``). ``resize_linear`` computes
``cv2.resize(img, (w, h))`` (INTER_LINEAR) on uint8 images bit for bit.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

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
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: not a PNG or JPEG file")


# SOFn markers the decoder refuses -> the mode named in the error
_UNSUPPORTED_SOF = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)", 0xC5: "hierarchical sequential (SOF5)",
    0xC6: "hierarchical progressive (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)", 0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}


class _Frame:
    """SOF0/SOF1's header: size, components (id, h, v, quantisation table)
    and each component's coefficient buffer."""

    def __init__(self, body: bytes, path: str):
        if len(body) < 6 or len(body) < 6 + 3 * body[5]:
            raise ValueError(f"{path}: truncated JPEG frame header")
        precision, self.height, self.width, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise ValueError(f"{path}: JPEG with {precision}-bit samples; only 8-bit is decoded")
        if self.height == 0 or self.width == 0:
            raise ValueError(f"{path}: JPEG with a {self.width}x{self.height} frame (DNL height is not read)")
        if n not in (1, 3):
            mode = "CMYK/YCCK (4 components)" if n == 4 else f"{n} components"
            raise ValueError(f"{path}: JPEG with {mode}; only gray and YCbCr are decoded")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        if n == 1:  # one component is one block per MCU whatever its factors
            self.h, self.v = [1], [1]
        self.hmax, self.vmax = max(self.h), max(self.v)
        if any(not 1 <= f <= 4 for f in self.h + self.v) or any(
            self.hmax % h or self.vmax % v for h, v in zip(self.h, self.v)
        ):
            raise ValueError(
                f"{path}: JPEG with sampling factors {list(zip(self.h, self.v))}; only integer ratios are upsampled"
            )
        self.mcus_x = _ceil_div(self.width, 8 * self.hmax)
        self.mcus_y = _ceil_div(self.height, 8 * self.vmax)
        # block rows and columns of each component, padded to whole MCUs
        self.blocks = [(self.mcus_y * v, self.mcus_x * h) for h, v in zip(self.h, self.v)]
        sizes = [bh * bw * 64 for bh, bw in self.blocks]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self.coefs = np.zeros(int(sum(sizes)), np.int16)


def _exif_orientation(body: bytes) -> int:
    """The Orientation tag (0x0112) of an APP1 Exif payload's first IFD, 1 if absent."""
    tiff = body[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd: ifd + 2])
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(e + "HH", entry[:4])
        if tag == 0x0112 and kind == 3:
            (value,) = struct.unpack(e + "H", entry[8:10])
            return value
    return 1


def _apply_exif_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The decoded image as cv2 shows it for an EXIF Orientation of 1-8
    (others leave it as it is)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if flip:
        img = np.flip(img, flip)
    return np.ascontiguousarray(img)


def _next_marker(data: bytes, pos: int) -> int:
    """The position of the first marker (0xFF, then neither 0x00 nor 0xFF) at or after ``pos``."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            return len(data)
        if data[pos + 1] not in (0x00, 0xFF) and not 0xD0 <= data[pos + 1] <= 0xD7:
            return pos
        pos += 1


def decode_jpeg(data: bytes, path: str = "<jpeg>") -> np.ndarray:
    """A JPEG file's bytes -> BGR HWC uint8, as ``cv2.imread`` returns it."""
    from ihmr_tpu_torch.data import native

    quant: Dict[int, np.ndarray] = {}
    tables = np.zeros((8, 272), np.uint8)  # DC 0-3, AC 0-3: 16 code counts + 256 values
    defined = [False] * 8
    frame: Optional[_Frame] = None
    restart = 0
    orientation = None
    saw_jfif = False
    adobe_transform = None
    pos = 2
    buf = np.frombuffer(data, np.uint8)
    while True:
        pos = _next_marker(data, pos)
        if pos + 2 > len(data):
            raise ValueError(f"{path}: JPEG ends before its EOI marker")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if marker == 0x01:  # TEM: no segment
            continue
        if pos + 2 > len(data):
            raise ValueError(f"{path}: JPEG segment header past the end of the file")
        (length,) = struct.unpack(">H", data[pos: pos + 2])
        if length < 2 or pos + length > len(data):
            raise ValueError(f"{path}: JPEG segment 0xFF{marker:02X} with length {length} runs past the file")
        body = data[pos + 2: pos + length]
        pos += length
        if marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{path}: {_UNSUPPORTED_SOF[marker]} JPEG; only sequential Huffman-coded files are decoded")
        if marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG (DAC); only Huffman-coded files are decoded")
        if marker in (0xC0, 0xC1):
            frame = _Frame(body, path)
        elif marker == 0xDB:  # DQT: 8- or 16-bit tables in zig-zag order
            q = 0
            while q < len(body):
                pq, tq = body[q] >> 4, body[q] & 15
                size = 128 if pq else 64
                if q + 1 + size > len(body):
                    raise ValueError(f"{path}: truncated JPEG quantisation table")
                vals = np.frombuffer(body[q + 1: q + 1 + size], ">u2" if pq else np.uint8).astype(np.uint16)
                natural = np.zeros(64, np.uint16)
                natural[_ZIGZAG] = vals
                quant[tq] = natural
                q += 1 + size
        elif marker == 0xC4:  # DHT
            q = 0
            while q < len(body):
                tc, th = body[q] >> 4, body[q] & 15
                if th > 3:
                    raise ValueError(f"{path}: JPEG Huffman table id {th}; ids 0-3 are defined")
                counts = np.frombuffer(body[q + 1: q + 17], np.uint8)
                total = int(counts.sum())
                if len(counts) < 16 or total > 256 or q + 17 + total > len(body):
                    raise ValueError(f"{path}: truncated or oversized JPEG Huffman table")
                slot = 4 * (tc != 0) + (th & 3)
                tables[slot] = 0
                tables[slot, :16] = counts
                tables[slot, 16: 16 + total] = np.frombuffer(body[q + 17: q + 17 + total], np.uint8)
                defined[slot] = True
                q += 17 + total
        elif marker == 0xDD:  # DRI
            if len(body) < 2:
                raise ValueError(f"{path}: truncated JPEG restart interval")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
            saw_jfif = True
        elif marker == 0xE1 and body.startswith(b"Exif\x00\x00") and orientation is None:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDA:  # SOS, then the entropy-coded data
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            pos = _decode_scan(frame, body, buf, pos, tables, defined, restart, native, path)
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    if len(frame.ids) == 3 and not saw_jfif and (adobe_transform == 0 or (
            adobe_transform is None and frame.ids == [82, 71, 66])):
        raise ValueError(f"{path}: RGB-coded JPEG (Adobe transform 0 or components 'R', 'G', 'B'); "
                         "only gray and YCbCr are decoded")
    missing = sorted({t for t in frame.tq if t not in quant})
    if missing:
        raise ValueError(f"{path}: JPEG without quantisation tables {missing}")
    comps = np.array([(h, v, bw, bh) for h, v, (bh, bw) in zip(frame.h, frame.v, frame.blocks)], np.int32)
    q = np.ascontiguousarray(np.stack([quant[t] for t in frame.tq]))
    out = np.empty((frame.height, frame.width, 3), np.uint8)
    if native.jpeg_finish(frame.coefs, comps, frame.offsets, q, frame.hmax, frame.vmax, out):
        raise ValueError(f"{path}: JPEG sampling factors {list(zip(frame.h, frame.v))} are not upsampled")
    return _apply_exif_orientation(out, orientation or 1)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _decode_scan(frame: _Frame, body: bytes, buf: np.ndarray, pos: int, tables: np.ndarray, defined: List[bool],
                 restart: int, native, path: str) -> int:
    """Entropy-decode one scan into ``frame.coefs``; returns the position after its data."""
    if not body or not 1 <= body[0] <= 4 or len(body) < 4 + 2 * body[0]:
        raise ValueError(f"{path}: malformed JPEG scan header")
    ns = body[0]
    spec = body[1: 1 + 2 * ns]
    ss, se, ahal = body[1 + 2 * ns: 4 + 2 * ns]
    if ss != 0 or se != 63 or ahal != 0:
        raise ValueError(f"{path}: JPEG scan with spectral selection {ss}-{se} / approximation {ahal}; "
                         "only sequential scans are decoded")
    comps = np.zeros((ns, 7), np.int32)
    offsets = np.zeros(ns, np.int64)
    for i in range(ns):
        cid, tdta = spec[2 * i], spec[2 * i + 1]
        if cid not in frame.ids:
            raise ValueError(f"{path}: JPEG scan names component {cid}, not in the frame")
        c = frame.ids.index(cid)
        td, ta = tdta >> 4, tdta & 15
        if td > 3 or ta > 3 or not defined[td] or not defined[4 + ta]:
            raise ValueError(f"{path}: JPEG scan uses an undefined Huffman table (DC {td}, AC {ta})")
        comps[i] = (c, td, ta, frame.h[c], frame.v[c], frame.blocks[c][1], 0)
        offsets[i] = frame.offsets[c]
    if ns == 1:  # a non-interleaved scan covers the component's own blocks, one per MCU
        c = comps[0, 0]
        mcus_x = _ceil_div(_ceil_div(frame.width * frame.h[c], frame.hmax), 8)
        mcus_y = _ceil_div(_ceil_div(frame.height * frame.v[c], frame.vmax), 8)
    else:
        mcus_x, mcus_y = frame.mcus_x, frame.mcus_y
    end = native.jpeg_decode_scan(buf, pos, comps, offsets, tables, mcus_x, mcus_y, restart, frame.coefs)
    if end < 0:
        raise ValueError(f"{path}: JPEG with an empty Huffman table")
    return int(end)


# natural index of each zig-zag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
])


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


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A BGR HWC uint8 image -> the JPEG bytes ``cv2.imencode(".jpg", img)``
    returns (baseline, 4:2:0, ``quality`` as IMWRITE_JPEG_QUALITY)."""
    from ihmr_tpu_torch.data.native import jpeg_encode_bgr

    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (H, W, 3) BGR images, got {img.dtype} {img.shape}")
    return jpeg_encode_bgr(img, quality)


def imwrite_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write a BGR HWC uint8 image as the JPEG file ``cv2.imwrite(path, img)`` writes."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


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
