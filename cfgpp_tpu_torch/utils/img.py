"""Image output helpers (host side), counterpart of the parts of
``cfgpp_tpu/utils/img.py`` that the engine's output needs.

PNGs are written with the standard library's zlib, so saving an image needs
no imaging package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def normalize(img: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1]."""
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Float images in [0, 1] -> uint8, rounding half up."""
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8)


def _png_bytes(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG file."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),          # filter: none
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image(img, path, normalize_img: bool = False) -> None:
    """Save one float image in [0, 1] ([1, H, W, 3] or [H, W, 3]) as PNG."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError(f"save_image takes one image; got {arr.shape}")
        arr = arr[0]
    if normalize_img:
        arr = normalize(arr)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(_png_bytes(to_uint8(arr)))
