"""The port's JPEG writer and the two OpenCV drawing calls the renderer needs,
against cv2 5.0 (libjpeg-turbo 3.1.2) on this machine.

``image_io.encode_jpeg`` must return the bytes ``cv2.imencode(".jpg")``
returns, at its defaults (quality 95, 4:2:0) and at other qualities, over
the ``image_cases.ENCODE_SIZES`` (one pixel, partial MCUs, a whole MCU, the
renders' 896x448) and flat, ramp and random content; the committed digests
(``tests/data/jpeg/encode_expected.json``) must be cv2's, and
``check_encoder`` holds the port to them without cv2. ``fill_circle_r2`` is
``cv2.circle(img, c, 2, col, -1)`` at every centre of a small image, off
the image included; ``resize_linear_float`` is ``cv2.resize`` on float32
within 1e-4 (OpenCV fuses its vector multiply-adds).
"""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from ihmr_tpu_torch.data import cv_ops, image_cases, image_io
from tests.torch_threads import one_torch_thread  # noqa: F401

CONTENTS = ("flat", "ramps", "random")


def _image(h, w, content, seed):
    rng = np.random.RandomState(seed)
    if content == "flat":
        return np.broadcast_to(rng.randint(0, 256, 3).astype(np.uint8), (h, w, 3)).copy()
    if content == "ramps":
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (3 * xx + yy) % 256], -1).astype(np.uint8)
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("size", image_cases.ENCODE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("content", CONTENTS)
def test_encoder_writes_cv2s_bytes(size, content):
    img = _image(*size, content, seed=size[0] * 1000 + size[1])
    assert image_io.encode_jpeg(img) == cv2.imencode(".jpg", img)[1].tobytes()


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 100])
def test_encoder_at_other_qualities(quality):
    rng = np.random.RandomState(quality)
    for h, w in ((5, 3), (17, 33), (40, 24)):
        img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), (0, 0), 1.5)
        ours = image_io.encode_jpeg(img, quality)
        assert ours == cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


def test_committed_digests_are_cv2s_and_the_port_meets_them(tmp_path):
    with open(os.path.join(image_cases.FIXTURE_DIR, image_cases.ENCODE_FILE)) as f:
        expected = json.load(f)
    inputs = image_cases.encode_inputs()
    assert sorted(expected) == sorted(inputs) and len(inputs) == 2 * len(image_cases.ENCODE_SIZES)
    for name, img in inputs.items():
        assert hashlib.sha256(cv2.imencode(".jpg", img)[1].tobytes()).hexdigest() == expected[name], name
    assert sorted(image_cases.check_encoder()) == sorted(expected)
    # imwrite_jpeg writes the same file as cv2.imwrite; both decoders read it alike
    img = inputs["ramps_33x65"]
    ours, ref = str(tmp_path / "ours.jpg"), str(tmp_path / "ref.jpg")
    image_io.imwrite_jpeg(ours, img)
    cv2.imwrite(ref, img)
    assert open(ours, "rb").read() == open(ref, "rb").read()
    np.testing.assert_array_equal(image_io.imread(ours), cv2.imread(ref))


def test_encoder_rejects_what_it_cannot_write():
    with pytest.raises(ValueError):
        image_io.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        image_io.encode_jpeg(np.zeros((4, 4, 3), np.float32))


def test_fill_circle_is_cv2_circle_at_every_centre():
    h, w = 7, 6
    for y in range(-3, h + 3):
        for x in range(-3, w + 3):
            ref = np.zeros((h, w, 3), np.uint8)
            cv2.circle(ref, (x, y), 2, (255, 51, 51), -1)
            ours = np.zeros((h, w, 3), np.uint8)
            cv_ops.fill_circle_r2(ours, (x, y), (255, 51, 51))
            np.testing.assert_array_equal(ours, ref, err_msg=f"centre {(x, y)}")


def test_resize_linear_float_within_1e4_of_cv2():
    rng = np.random.RandomState(0)
    worst = 0.0
    for i in range(120):
        H, W = rng.randint(2, 90, 2)
        h, w = rng.randint(1, 90, 2)
        if i % 10 == 0:  # exact halvings: the area average
            h, w = max(H // 2, 1), max(W // 2, 1)
            H, W = 2 * h, 2 * w
        img = (rng.rand(H, W, 3) * 255).astype(np.float32)
        ours = cv_ops.resize_linear_float(img, (int(w), int(h)))
        ref = cv2.resize(img, (int(w), int(h)))
        assert ours.shape == ref.shape and ours.dtype == np.float32
        worst = max(worst, float(np.abs(ours - ref).max()))
    assert worst <= 1e-4, worst
    img = rng.rand(9, 11).astype(np.float32) * 255  # 2D
    np.testing.assert_allclose(cv_ops.resize_linear_float(img, (5, 13)), cv2.resize(img, (5, 13)), atol=1e-4)
