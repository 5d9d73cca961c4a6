"""Write ``encode_expected.json``: the SHA-256 of the bytes ``cv2.imencode(".jpg")``
writes, at its defaults, for each image of
``ihmr_tpu_torch.data.image_cases.encode_inputs()``.

    python tests/data/jpeg/make_encode_digests.py

Needs cv2. ``image_cases.check_encoder`` holds the port's JPEG writer to
these digests on machines without cv2 (``chip_smoke.py``, the purity test).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    import cv2

    sys.path.insert(0, os.path.abspath(os.path.join(HERE, "..", "..", "..")))
    from ihmr_tpu_torch.data.image_cases import ENCODE_FILE, encode_inputs

    digests = {name: hashlib.sha256(cv2.imencode(".jpg", img)[1].tobytes()).hexdigest()
               for name, img in encode_inputs().items()}
    with open(os.path.join(HERE, ENCODE_FILE), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(digests)} digests to {os.path.join(HERE, ENCODE_FILE)} (cv2 {cv2.__version__})")


if __name__ == "__main__":
    main()
