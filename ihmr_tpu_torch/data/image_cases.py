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
