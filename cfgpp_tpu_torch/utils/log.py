"""Logging, workdir and seeding helpers, counterpart of
``cfgpp_tpu/utils/log.py`` (the reference's ``utils/log_util.py``).

``make_gif`` stitches saved frames into an animated GIF with its own
GIF89a writer (numpy and an LZW coder in Python), because the card's
machine has no PIL.
"""

from __future__ import annotations

import logging
import struct
import sys
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def get_logger(name: str = "cfgpp_tpu_torch", level: int = logging.INFO,
               logfile: Optional[str] = None) -> logging.Logger:
    """A logger to stdout (and ``logfile``); the level and the file are
    applied on every call, so a later, more specific call takes effect."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.setLevel(level)
    if logfile and not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == str(Path(logfile).absolute())
            for h in logger.handlers):
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def create_workdir(workdir) -> Path:
    """Make <workdir>/result (log_util.py:44-45)."""
    p = Path(workdir)
    p.joinpath("result").mkdir(parents=True, exist_ok=True)
    return p


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy (host-side shuffling) and return a CPU torch.Generator
    seeded with ``seed``.  The engine takes an explicit seed for each
    request and seeds its own generators on the device, so no global
    torch RNG is seeded here."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


# GIF89a pieces: the loop extension (NETSCAPE2.0, a loop count of 0: loop for
# ever) and the LZW code limit
_GIF_LOOP = b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
_LZW_MAX_CODES = 4096


def _gif_palette(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[H, W, 3] uint8 -> (indices [H, W] uint8, palette [n, 3] uint8), n <=
    256.  A frame of at most 256 colours keeps them exactly.  A frame of
    more is quantized to a fixed 8 x 8 x 4 colour cube (3 bits of red, 3 of
    green, 2 of blue): each sample goes to the nearest of its axis' evenly
    spaced levels, with no dithering."""
    h, w, _ = rgb.shape
    flat = rgb.reshape(-1, 3).astype(np.uint32)
    key = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    colours, inverse = np.unique(key, return_inverse=True)
    if len(colours) <= 256:
        palette = np.stack([colours >> 16, (colours >> 8) & 255,
                            colours & 255], axis=-1).astype(np.uint8)
        return inverse.reshape(h, w).astype(np.uint8), palette
    steps = np.array([7, 7, 3], np.uint32)
    level = (flat * steps + 127) // 255                    # nearest level
    index = (level[:, 0] << 5) | (level[:, 1] << 2) | level[:, 2]
    cube = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    palette = ((cube * 255 + steps // 2) // steps).astype(np.uint8)
    return index.reshape(h, w).astype(np.uint8), palette


def _lzw(indices: bytes, min_size: int) -> bytes:
    """GIF's variable-width LZW code stream of ``indices``, packed least
    significant bit first; a clear code starts it and restarts it whenever
    the 4096-entry table is full."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0
    size, next_code, table = min_size + 1, end + 1, {}

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < _LZW_MAX_CODES:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            size, next_code, table = min_size + 1, end + 1, {}
        prefix = b
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif_bytes(frames: Sequence[np.ndarray], duration: int = 100) -> bytes:
    """[H, W, 3] uint8 frames -> an animated GIF89a file: each frame at the
    top left of a screen as large as the largest, with its own colour table
    (`_gif_palette`), shown for ``duration`` ms (stored, as PIL stores it,
    in whole hundredths of a second, rounded down), looping for ever."""
    width = max(f.shape[1] for f in frames)
    height = max(f.shape[0] for f in frames)
    out = [b"GIF89a", struct.pack("<HHBBB", width, height, 0, 0, 0),
           _GIF_LOOP]
    for frame in frames:
        indices, palette = _gif_palette(np.asarray(frame, np.uint8))
        bits = max(1, int(len(palette) - 1).bit_length())
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        min_size = max(2, bits)
        data = _lzw(indices.tobytes(), min_size)
        out += [b"!\xf9\x04\x00" + struct.pack("<HB", int(duration / 10), 0)
                + b"\x00",                        # graphic control extension
                b"," + struct.pack("<HHHHB", 0, 0, frame.shape[1],
                                   frame.shape[0], 0x80 | (bits - 1)),
                table.tobytes(), bytes([min_size])]
        out += [bytes([len(data[i:i + 255])]) + data[i:i + 255]
                for i in range(0, len(data), 255)]
        out.append(b"\x00")
    out.append(b";")
    return b"".join(out)


def make_gif(image_paths: Sequence, save_path, duration: int = 100) -> None:
    """Stitch saved PNG (or JPEG) frames into a GIF that loops for ever,
    ``duration`` ms a frame (log_util.py:28-37 parity), with `gif_bytes`;
    each frame read by `cfgpp_tpu_torch.utils.img.read_image`.  A frame of
    more than 256 colours is quantized (see `_gif_palette`)."""
    from cfgpp_tpu_torch.utils.img import read_image

    frames = [read_image(p) for p in image_paths]
    if not frames:
        return
    Path(save_path).write_bytes(gif_bytes(frames, duration))


def save_floats(values: Sequence[float], path) -> None:
    """One float a line."""
    with open(path, "w") as f:
        for v in values:
            f.write(f"{float(v)}\n")
