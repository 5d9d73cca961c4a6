"""The committed JPEG fixtures and cv2's results on them, held against the port.

``tests/data/jpeg/`` holds small JPEGs and ``expected.json``: the SHA-256 of
the bytes ``cv2.imread`` returns for each, and of cv2's results for the
augmentation cases on one input (written by
``tests/data/jpeg/make_fixtures.py`` where cv2 is installed).
``check_fixtures`` decodes every fixture and runs every case with the port's
own code, on a machine with or without cv2, and raises on the first result
that is not cv2's: decode, warp, HSV conversions and colour jitter byte for
byte; filter2D within ``FILTER2D_MAX_DIFF`` on at most ``FILTER2D_MAX_SHARE``
of the values (cv2 sums large kernels through a DFT).

``encode_expected.json`` holds the SHA-256 of the bytes ``cv2.imencode(".jpg")``
writes for ``encode_inputs()`` (seeded noise and smooth ramps at the
``ENCODE_SIZES``; written by ``tests/data/jpeg/make_encode_digests.py``);
``check_encoder`` encodes the same images with the port's writer and
raises on the first whose bytes differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
from typing import Dict

import numpy as np

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                           "tests", "data", "jpeg")
ENCODE_FILE = "encode_expected.json"
# (height, width) of the encoder's cases: one pixel, partial MCUs on either
# side, one whole MCU, a wide odd one, the encoder's input and the renders' size
ENCODE_SIZES = ((1, 1), (7, 9), (15, 17), (16, 16), (33, 65), (224, 224), (896, 448))
FILTER2D_MAX_DIFF = 1
FILTER2D_MAX_SHARE = 1e-4


def sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def load_expected(fixture_dir: str = FIXTURE_DIR) -> dict:
    with open(os.path.join(fixture_dir, "expected.json")) as f:
        return json.load(f)


def augmentation_input(fixture_dir: str = FIXTURE_DIR) -> np.ndarray:
    """The cases' input: the first corpus JPEG letterboxed to 224x224."""
    from ihmr_tpu_torch.data import preprocess as pp
    from ihmr_tpu_torch.data.image_io import imread

    name = load_expected(fixture_dir)["augment"]["input"].split()[0]
    return pp.padding_and_resize(imread(os.path.join(fixture_dir, name)), np.zeros((42, 3), np.float32), 224)[0]


def check_fixtures(fixture_dir: str = FIXTURE_DIR) -> Dict[str, object]:
    """Every fixture and augmentation case through the port; raises
    AssertionError naming the first that differs from cv2. Returns what was
    checked: {"decoded": [names], "filter2d": {size: (max |diff|, share of
    values that differ)}, "cases": count}."""
    from ihmr_tpu_torch.data import cv_ops
    from ihmr_tpu_torch.data import preprocess as pp
    from ihmr_tpu_torch.data.image_io import imread
    from ihmr_tpu_torch.data.synthetic import BLUR_PSFS, motion_psf

    expected = load_expected(fixture_dir)
    decoded = []
    for name, want in sorted(expected["decode"].items()):
        img = imread(os.path.join(fixture_dir, name))
        if list(img.shape) != want["shape"] or sha256(img) != want["sha256"]:
            raise AssertionError(f"{name}: decoded {img.shape}, not the bytes cv2.imread returns ({want['shape']})")
        decoded.append(name)

    aug = expected["augment"]
    src = augmentation_input(fixture_dir)
    if sha256(src) != aug["input_sha256"]:
        raise AssertionError("the augmentation input (decode + letterbox) differs from cv2's")
    results = {f"rotate_image {a}": pp.rotate_image(src.copy(), float(a)) for a in aug["rotate_image"]}
    hsv = cv_ops.bgr_to_hsv(src)
    results["bgr_to_hsv"] = hsv
    results["hsv_to_bgr"] = cv_ops.hsv_to_bgr(hsv)
    results.update({f"color_jitter {s}": pp.color_jitter(src, random.Random(int(s))) for s in aug["color_jitter"]})
    wants = {f"rotate_image {a}": d for a, d in aug["rotate_image"].items()}
    wants.update(bgr_to_hsv=aug["bgr_to_hsv"], hsv_to_bgr=aug["hsv_to_bgr"])
    wants.update({f"color_jitter {s}": d for s, d in aug["color_jitter"].items()})
    for case, img in results.items():
        if sha256(img) != wants[case]:
            raise AssertionError(f"{case}: not the bytes cv2 gives")

    blur = {}
    for size, angle in BLUR_PSFS:
        want = imread(os.path.join(fixture_dir, aug["filter2d"][str(size)])).astype(np.int16)
        diff = np.abs(cv_ops.filter2d(src, motion_psf(size, angle)).astype(np.int16) - want)
        blur[size] = (int(diff.max()), float((diff > 0).mean()))
        if diff.max() > FILTER2D_MAX_DIFF or (diff > 0).mean() > FILTER2D_MAX_SHARE:
            raise AssertionError(f"filter2d with the {size}x{size} PSF: max |diff| {diff.max()}, "
                                 f"{(diff > 0).mean():.2e} of the values differ (bound {FILTER2D_MAX_DIFF} on "
                                 f"{FILTER2D_MAX_SHARE})")
    return {"decoded": decoded, "filter2d": blur, "cases": len(results) + len(blur)}


def encode_inputs() -> Dict[str, np.ndarray]:
    """{name: BGR uint8 image} for each of ``ENCODE_SIZES``: uniform noise
    (``noise_HxW``) and smooth ramps with a little noise (``ramps_HxW``),
    from ``np.random.RandomState(i)`` and integer arithmetic only, so every
    host makes the same images."""
    out = {}
    for i, (h, w) in enumerate(ENCODE_SIZES):
        rng = np.random.RandomState(i)
        out[f"noise_{h}x{w}"] = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        ramps = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + 2 * yy) % 256], -1)
        out[f"ramps_{h}x{w}"] = np.clip(ramps + rng.randint(-4, 5, (h, w, 3)), 0, 255).astype(np.uint8)
    return out


def check_encoder(fixture_dir: str = FIXTURE_DIR) -> Dict[str, int]:
    """Encode every ``encode_inputs()`` image with the port's JPEG writer;
    raises AssertionError naming the first whose bytes are not cv2's (by
    the committed digests). Returns {name: bytes written}."""
    from ihmr_tpu_torch.data.image_io import encode_jpeg

    with open(os.path.join(fixture_dir, ENCODE_FILE)) as f:
        expected = json.load(f)
    written = {}
    for name, img in encode_inputs().items():
        data = encode_jpeg(img)
        if hashlib.sha256(data).hexdigest() != expected[name]:
            raise AssertionError(f"{name}: the JPEG bytes are not those cv2.imencode writes")
        written[name] = len(data)
    if sorted(written) != sorted(expected):
        raise AssertionError(f"encode cases {sorted(written)} against digests of {sorted(expected)}")
    return written
