"""The port's JPEG decoder (``image_io.imread`` / ``decode_jpeg``, with
``csrc/jpeg_decode.cpp``) against ``cv2.imread``.

Bound everywhere: equal byte for byte, shape included. Cases: qualities
50 / 75 / 95; sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 at sizes that
are not multiples of 16 (and at 3x5 and 1x1, where libjpeg-turbo upsamples
a narrow component by replication); grayscale; restart intervals; noise at
quality 100; the eight EXIF orientations in both byte orders, the APP1
segment injected into cv2's output; and the committed fixtures of
``tests/data/jpeg/`` against their stored digests (what the card's machine,
which has no cv2, checks). Files the decoder does not implement raise a
ValueError naming the file and the mode: progressive, arithmetic-coded,
lossless, hierarchical, 12-bit, CMYK, RGB-coded (Adobe transform 0) and
sampling factors that are not integer ratios.
"""

import os
import struct

import numpy as np
import pytest

from ihmr_tpu_torch.data import image_io, native
from ihmr_tpu_torch.data.image_cases import FIXTURE_DIR, check_fixtures, load_expected, sha256

cv2 = pytest.importorskip("cv2")

SAMPLING = {
    "444": "IMWRITE_JPEG_SAMPLING_FACTOR_444", "422": "IMWRITE_JPEG_SAMPLING_FACTOR_422",
    "420": "IMWRITE_JPEG_SAMPLING_FACTOR_420", "440": "IMWRITE_JPEG_SAMPLING_FACTOR_440",
    "411": "IMWRITE_JPEG_SAMPLING_FACTOR_411",
}


def _smooth(height, width, seed, channels=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    planes = [np.sin(xx / (5.0 + 2 * k) + k) * 80 + np.cos(yy / (7.0 + k) - k) * 60 + 128 for k in range(channels)]
    img = np.clip(np.rint(np.stack(planes, -1) + rng.normal(0, 10, (height, width, channels))), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _encode(img, params=()):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _same_as_cv2(tmp_path, data, name="case.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    ref, ours = cv2.imread(path), image_io.imread(path)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = ours.astype(np.int16) - ref
    assert not diff.any(), f"{np.count_nonzero(diff)} values differ, by up to {np.abs(diff).max()}"


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_qualities(tmp_path, quality):
    _same_as_cv2(tmp_path, _encode(_smooth(96, 136, quality), [cv2.IMWRITE_JPEG_QUALITY, quality]))


@pytest.mark.parametrize("size", [(77, 101), (64, 48), (3, 5), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_sampling_factors(tmp_path, sampling, size):
    flag = getattr(cv2, SAMPLING[sampling])
    data = _encode(_smooth(*size, seed=3), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag, cv2.IMWRITE_JPEG_QUALITY, 90])
    _same_as_cv2(tmp_path, data)


@pytest.mark.parametrize("size", [(50, 70), (17, 9)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_grayscale(tmp_path, size):
    _same_as_cv2(tmp_path, _encode(_smooth(*size, seed=4, channels=1)))


@pytest.mark.parametrize("interval,sampling", [(1, "420"), (3, "444"), (5, "422")])
def test_restart_intervals(tmp_path, interval, sampling):
    data = _encode(_smooth(83, 97, seed=5), [cv2.IMWRITE_JPEG_RST_INTERVAL, interval, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             getattr(cv2, SAMPLING[sampling])])
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _same_as_cv2(tmp_path, data)


def test_noise_at_quality_100(tmp_path):
    """Large coefficients: long Huffman codes and the IDCT's range limit."""
    img = np.random.default_rng(6).integers(0, 256, (41, 57, 3), dtype=np.uint8)
    _same_as_cv2(tmp_path, _encode(img, [cv2.IMWRITE_JPEG_QUALITY, 100]))


def _app1(orientation, order):
    e = "<" if order == b"II" else ">"
    tiff = order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
    tiff += struct.pack(e + "HHI", 0x010F, 2, 4) + b"cam\x00"  # Make, before the tag that counts
    tiff += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["little", "big"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation, order):
    plain = _encode(_smooth(40, 60, seed=orientation))
    data = plain[:2] + _app1(orientation, order) + plain[2:]
    _same_as_cv2(tmp_path, data)
    if orientation >= 5:
        assert image_io.decode_jpeg(data).shape == (60, 40, 3)


@pytest.mark.parametrize("name", sorted(load_expected()["decode"]))
def test_fixture_digests(name):
    """Each committed fixture decodes to the digest of cv2's bytes, and cv2 still reads it so."""
    want = load_expected()["decode"][name]
    path = os.path.join(FIXTURE_DIR, name)
    assert sha256(cv2.imread(path)) == want["sha256"]
    img = image_io.imread(path)
    assert list(img.shape) == want["shape"] and sha256(img) == want["sha256"]


def test_check_fixtures_passes_here():
    """The check ``chip_smoke.py`` runs on the card's host."""
    out = check_fixtures()
    assert len(out["decoded"]) == len(load_expected()["decode"]) and out["cases"] == 17


def _segment(data, marker):
    """Offset of the first segment ``marker`` (the 0xFF byte)."""
    pos = 2
    while data[pos + 1] != marker:
        (length,) = struct.unpack(">H", data[pos + 2: pos + 4])
        pos += 2 + length
    return pos


def _patched(data, marker, offset, value):
    """``data`` with one byte of segment ``marker``'s body (after the length) replaced."""
    out = bytearray(data)
    out[_segment(data, marker) + 4 + offset] = value
    return bytes(out)


def _unsupported_cases():
    base = _encode(_smooth(32, 48, seed=7), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    sof = _segment(base, 0xC0)
    retag = lambda marker: base[: sof + 1] + bytes([marker]) + base[sof + 2:]  # noqa: E731
    # SOF0 body: precision, height (2), width (2), count, then (id, hv, tq) per component
    app0 = _segment(base, 0xE0)
    no_jfif = base[:app0] + base[app0 + 2 + struct.unpack(">H", base[app0 + 2: app0 + 4])[0]:]
    adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    cmyk = b"\xff\xd8\xff\xc0" + struct.pack(">HBHHB", 20, 8, 8, 8, 4) + bytes(
        [1, 0x11, 0, 2, 0x11, 0, 3, 0x11, 0, 4, 0x11, 0]) + b"\xff\xd9"
    return {
        "progressive (SOF2)": _encode(_smooth(32, 48, seed=8), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "lossless (SOF3)": retag(0xC3),
        "hierarchical sequential (SOF5)": retag(0xC5),
        "arithmetic-coded sequential (SOF9)": retag(0xC9),
        "12-bit samples": _patched(base, 0xC0, 0, 12),
        "CMYK/YCCK (4 components)": cmyk,
        "RGB-coded JPEG": no_jfif[:2] + adobe + no_jfif[2:],
        "sampling factors [(3, 2), (2, 1), (1, 1)]": _patched(_patched(base, 0xC0, 7, 0x32), 0xC0, 10, 0x21),
    }


@pytest.mark.parametrize("mode", sorted(_unsupported_cases()))
def test_unsupported_files_raise_naming_file_and_mode(tmp_path, mode):
    path = str(tmp_path / f"unsupported_{len(mode)}.jpg")
    with open(path, "wb") as f:
        f.write(_unsupported_cases()[mode])
    with pytest.raises(ValueError) as err:
        image_io.imread(path)
    assert path in str(err.value) and mode in str(err.value), str(err.value)


def test_malformed_files_raise_naming_the_file(tmp_path):
    """Truncated segments and a file cut inside its scan raise a ValueError
    that names the file (cv2 would return a partly grey image for the last)."""
    base = _encode(_smooth(32, 48, seed=9))

    def shortened(marker, keep):
        """Segment ``marker`` cut to its first ``keep`` body bytes, its length field saying so."""
        at = _segment(base, marker)
        (length,) = struct.unpack(">H", base[at + 2: at + 4])
        return base[: at + 2] + struct.pack(">H", 2 + keep) + base[at + 4: at + 4 + keep] + base[at + 2 + length:]

    cases = {
        "frame": shortened(0xC0, 4),
        "huffman": shortened(0xC4, 10),
        "scan": shortened(0xDA, 1),
        "cut": base[: len(base) // 2],
    }
    for name, data in cases.items():
        path = str(tmp_path / f"malformed_{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match="malformed_" + name):
            image_io.imread(path)


def test_native_wrappers_check_their_buffers():
    data = np.zeros(4, np.uint8)
    comps = np.array([[0, 0, 0, 1, 1, 2, 0]], np.int32)
    with pytest.raises(ValueError, match="past the coefficient buffer"):
        native.jpeg_decode_scan(data, 0, comps, np.zeros(1, np.int64), np.zeros((8, 272), np.uint8), 2, 2, 0,
                                np.zeros(64, np.int16))
    with pytest.raises(ValueError, match="int16"):
        native.jpeg_decode_scan(data, 0, comps, np.zeros(1, np.int64), np.zeros((8, 272), np.uint8), 1, 1, 0,
                                np.zeros(64, np.int32))
    with pytest.raises(ValueError, match="past the coefficient buffer"):
        native.jpeg_finish(np.zeros(64, np.int16), np.array([[1, 1, 2, 1]], np.int32), np.zeros(1, np.int64),
                           np.ones((1, 64), np.uint16), 1, 1, np.zeros((8, 16, 3), np.uint8))
