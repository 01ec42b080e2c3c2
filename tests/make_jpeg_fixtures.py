"""Write the JPEG fixtures of ``tests/data/jpeg/`` and PIL's decodes of them.

    python tests/make_jpeg_fixtures.py        # from the repository root

The fixtures are small images in MS-COCO's shapes (640x480, 480x640,
500x375, and a greyscale 427x640), smooth content made from a seed, saved
by PIL as baseline 4:2:0 JPEGs at quality 90 and one progressive JPEG.
Beside each ``<name>.jpg`` lies ``<name>.png``: PIL's
``Image.open(f).convert("RGB")`` of it (greyscale stored as one channel).
``chip_smoke.py`` holds the port's JPEG decoder against the stored decodes
on the card's machine, which has no PIL; ``tests/test_torch_port_jpeg.py``
holds the stored decodes against PIL here, so they cannot drift.
"""

from pathlib import Path

import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parent / "data" / "jpeg"
# name: (width, height, mode, save options)
FIXTURES = {
    "coco_640x480": (640, 480, "RGB", {}),
    "coco_480x640": (480, 640, "RGB", {}),
    "coco_500x375_progressive": (500, 375, "RGB", {"progressive": True}),
    "coco_427x640_grey": (427, 640, "L", {}),
}


def smooth(width: int, height: int, seed: int) -> np.ndarray:
    """[H, W, 3] uint8: a few random low-frequency waves per channel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width] / max(width, height)
    out = np.zeros((height, width, 3))
    for c in range(3):
        for _ in range(4):
            fy, fx = rng.uniform(1, 12, 2)
            phase = rng.uniform(0, 2 * np.pi)
            out[..., c] += rng.uniform(15, 35) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + phase)
    return np.clip(128 + out, 0, 255).astype(np.uint8)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for seed, (name, (w, h, mode, opts)) in enumerate(FIXTURES.items()):
        img = Image.fromarray(smooth(w, h, seed))
        if mode == "L":
            img = img.convert("L")
        path = OUT / f"{name}.jpg"
        img.save(path, "JPEG", quality=90, subsampling="4:2:0", **opts)
        decoded = Image.open(path)
        decoded = decoded if mode == "L" else decoded.convert("RGB")
        decoded.save(OUT / f"{name}.png", optimize=True)


if __name__ == "__main__":
    main()
