"""Write the JPEG fixtures of this directory and what cv2 makes of them.

    JAX_PLATFORMS=cpu python tests/data/jpeg/make_fixtures.py

Needs cv2 and the JAX package (the reference). Writes, beside this script:

  * five small JPEGs of smooth seeded content, encoded by ``cv2.imencode``:
    the two ``CORPUS_SHAPES`` (256x192 and 192x256, cv2's defaults: quality
    95, 4:2:0), a grayscale one, a 4:2:2 one with a restart interval of 2
    MCUs, and one with an EXIF APP1 segment whose Orientation is 6 (rotate
    90 degrees clockwise: 40x60 stored, 60x40 shown);
  * ``expected.json``: per JPEG the shape and the SHA-256 of the bytes
    ``cv2.imread`` returns; and the augmentation cases on one input (the
    first corpus JPEG as cv2 reads it, letterboxed to 224x224 by the JAX
    package's ``padding_and_resize``): the SHA-256 of ``rotate_image`` at the
    ten angles of ``random_rotate``, of ``cv2.cvtColor`` BGR -> HSV and back,
    and of ``color_jitter`` with ``random.Random(seed)`` for three seeds;
  * ``filter2d_psf_<size>.png``: ``cv2.filter2D`` of the same input with each
    point-spread function of ``ihmr_tpu_torch.data.synthetic.BLUR_PSFS``
    (kept as images: the port's direct sum may differ from cv2's DFT by 1 on
    a few pixels, so a digest cannot hold it).

``chip_smoke.py`` and ``tests/test_torch_port_jpeg.py`` /
``tests/test_torch_port_augment.py`` read these on machines without cv2.
"""

from __future__ import annotations

import json
import os
import random
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROTATE_ANGLES = [180.0 / 10 * i - 90 for i in range(10)]  # random_rotate's ten slices
JITTER_SEEDS = (0, 1, 2)


def smooth_image(height: int, width: int, seed: int, channels: int = 3) -> np.ndarray:
    """Smooth waves plus a little seeded noise, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    planes = [np.sin(xx / (9.0 + 3 * k) + k) * 70 + np.cos(yy / (13.0 + 2 * k) - 2 * k) * 50 + 128
              for k in range(channels)]
    img = np.stack(planes, -1) + rng.normal(0.0, 6.0, (height, width, channels))
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment holding a little-endian EXIF IFD0 with only the Orientation tag."""
    tiff = b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
    tiff += struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def main() -> None:
    import cv2

    sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))
    from ihmr_tpu.data import preprocess as jpp
    from ihmr_tpu_torch.data.image_cases import sha256
    from ihmr_tpu_torch.data.synthetic import BLUR_PSFS, CORPUS_SHAPES, motion_psf

    files = {}
    for i, (h, w) in enumerate(CORPUS_SHAPES):
        files[f"corpus_{h}x{w}.jpg"] = cv2.imencode(".jpg", smooth_image(h, w, seed=i))[1].tobytes()
    files["gray_75x100.jpg"] = cv2.imencode(".jpg", smooth_image(75, 100, seed=7, channels=1))[1].tobytes()
    files["s422_rst_50x70.jpg"] = cv2.imencode(".jpg", smooth_image(50, 70, seed=8), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
    ])[1].tobytes()
    plain = cv2.imencode(".jpg", smooth_image(40, 60, seed=9))[1].tobytes()
    files["exif6_40x60.jpg"] = plain[:2] + exif_app1(6) + plain[2:]

    expected = {"decode": {}, "augment": {}}
    for name, data in files.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path)
        expected["decode"][name] = {"shape": list(img.shape), "sha256": sha256(img)}

    h, w = CORPUS_SHAPES[0]
    src = jpp.padding_and_resize(cv2.imread(os.path.join(HERE, f"corpus_{h}x{w}.jpg")), np.zeros((42, 3), np.float32),
                                 224)[0]
    hsv = cv2.cvtColor(src, cv2.COLOR_BGR2HSV)
    aug = expected["augment"]
    aug["input"] = f"corpus_{h}x{w}.jpg letterboxed to 224x224"
    aug["input_sha256"] = sha256(src)
    aug["rotate_image"] = {str(a): sha256(jpp.rotate_image(src.copy(), a)) for a in ROTATE_ANGLES}
    aug["bgr_to_hsv"] = sha256(hsv)
    aug["hsv_to_bgr"] = sha256(cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    aug["color_jitter"] = {str(s): sha256(jpp.color_jitter(src, random.Random(s))) for s in JITTER_SEEDS}
    aug["filter2d"] = {}
    for size, angle in BLUR_PSFS:
        name = f"filter2d_psf_{size}.png"
        cv2.imwrite(os.path.join(HERE, name), cv2.filter2D(src, -1, motion_psf(size, angle)))
        aug["filter2d"][str(size)] = name
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(files)} JPEGs, {len(BLUR_PSFS)} filter2D images and expected.json to {HERE}")


if __name__ == "__main__":
    main()
