"""Image IO helpers (host side), counterpart of the parts of
``cfgpp_tpu/utils/img.py`` that the engine and the CLIs need, and of
``cfgpp_tpu/native``'s `AsyncPngWriter`.

PNGs are written and read with the standard library's zlib, so saving and
loading an image needs no imaging package.  `load_image` reads 8-bit,
non-interlaced greyscale, RGB and RGBA PNGs; any other format raises.
`AsyncPngWriter` encodes and writes on worker threads: ``zlib.compress``
and the file write release the GIL, so the threads overlap each other and
the caller without a native library.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import List, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel: greyscale, RGB, greyscale+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# leading bytes of the formats load_image refuses, to name them
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"RIFF", "a RIFF container (WebP)"))


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


def _grid(imgs: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """[B, H, W, C] -> one grid image [H', W', C], ``nrow`` images a row,
    ``pad`` zero pixels between them (torchvision's ``make_grid`` without
    the outer border, as ``cfgpp_tpu/utils/img.py:_grid``)."""
    b, h, w, c = imgs.shape
    ncol = min(nrow, b)
    nr = (b + ncol - 1) // ncol
    grid = np.zeros((nr * (h + pad) - pad, ncol * (w + pad) - pad, c),
                    imgs.dtype)
    for i in range(b):
        r, col = divmod(i, ncol)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = imgs[i]
    return grid


def save_image(img, path, normalize_img: bool = False, nrow: int = 8) -> None:
    """Save float images in [0, 1] as one PNG: [H, W, 3], or [B, H, W, 3]
    with a batch of more than one written as a grid of ``nrow`` a row."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 4:
        arr = _grid(arr, nrow=nrow) if arr.shape[0] > 1 else arr[0]
    if normalize_img:
        arr = normalize(arr)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(_png_bytes(to_uint8(arr)))


def _rgb_u8(img: np.ndarray) -> np.ndarray:
    """float [H, W, 3] in [0, 1], or uint8 -> contiguous uint8 RGB."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected an [H, W, 3] image; got {arr.shape}")
    return np.ascontiguousarray(arr)


class AsyncPngWriter:
    """PNG writes on worker threads.  `submit` copies the pixels and
    returns; `wait` blocks until every write submitted so far has ended and
    returns the number of failed writes since the writer was made (each
    failure's (path, exception) is in ``errors``); `close` waits and stops
    the threads, and may be called again; the writer is a context manager.

    ``submit(path, img, ready=...)`` takes pixels that are still on their
    way, e.g. a pinned host buffer a device copy writes into: the worker
    calls ``ready.synchronize()`` (a ``torch.cuda.Event`` recorded after the
    copy) before it reads them, and the caller keeps the buffer untouched
    until then.  A failed write (including the parent directory's
    creation) is counted, never dropped."""

    def __init__(self, n_threads: int = 4):
        self._pool = ThreadPoolExecutor(n_threads, thread_name_prefix="png")
        self._pending: List[Tuple[Path, Future]] = []
        self.errors: List[Tuple[Path, BaseException]] = []
        self._closed = False

    def submit(self, path, img, ready=None) -> None:
        path = Path(path)
        pixels = img if ready is not None else _rgb_u8(img).copy()
        self._pending.append(
            (path, self._pool.submit(self._write, path, pixels, ready)))

    @staticmethod
    def _write(path: Path, pixels, ready) -> None:
        if ready is not None:
            ready.synchronize()
        data = _png_bytes(_rgb_u8(pixels))
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)

    def wait(self) -> int:
        pending, self._pending = self._pending, []
        for path, future in pending:
            err = future.exception()
            if err is not None:
                self.errors.append((path, err))
        return len(self.errors)

    def close(self) -> None:
        if not self._closed:
            self.wait()
            self._pool.shutdown(wait=True)
            self._closed = True

    def __enter__(self) -> "AsyncPngWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _unfilter_rows(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth):
    [h, stride] uint8 from the inflated IDAT stream."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of pixel data, expected"
                         f" {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:      # Sub: + the byte one pixel to the left
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint32)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:      # Up: + the byte above
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter type {kind}")
        out[y] = prior = cur
    return out


def read_png(data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced greyscale, RGB or RGBA PNG -> [H, W, 3] uint8:
    grey repeated over the three channels, alpha dropped (PIL's
    ``convert("RGB")``)."""
    if not data.startswith(_PNG_SIGNATURE):
        fmt = next((name for magic, name in _OTHER_FORMATS
                    if data.startswith(magic)), "an unknown format")
        raise ValueError(f"load_image reads PNG files only; this file is {fmt}")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += n + 12                      # length, tag, body, crc
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG: bit depth {depth}, colour type {colour},"
                         f" interlace {interlace}; load_image reads 8-bit"
                         " non-interlaced greyscale, RGB and RGBA")
    ch = _PNG_CHANNELS[colour]
    px = _unfilter_rows(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    return np.repeat(px[..., :1], 3, axis=-1) if ch < 3 else px[..., :3].copy()


_RESAMPLE_BITS = 22       # fraction bits of PIL's 8-bit resample weights


def _bicubic_taps(n_in: int, n_out: int):
    """PIL's bicubic resample along one axis (Pillow's Resample.c: the
    a = -0.5 cubic, stretched by the downscale factor so that it also
    antialiases, weights normalized and rounded to fixed point): per output
    index the first input index [n_out] and the integer weights
    [n_out, taps]."""
    scale = n_in / n_out
    stretch = max(scale, 1.0)
    support = 2.0 * stretch
    taps = int(np.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    weights = np.zeros((n_out, taps), np.int64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        x = np.abs((np.arange(lo, hi) - center + 0.5) / stretch)
        k = np.where(x < 1.0, (1.5 * x - 2.5) * x * x + 1.0,
                     np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5,
                              0.0))
        if k.sum() != 0.0:
            k = k / k.sum()
        first[i] = lo
        weights[i, :hi - lo] = np.trunc(k * 2 ** _RESAMPLE_BITS
                                        + np.where(k < 0, -0.5, 0.5))
    return first, weights


def _resample_axis(px: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along ``axis`` of a uint8 image."""
    n_in = px.shape[axis]
    first, weights = _bicubic_taps(n_in, n_out)
    src = np.moveaxis(px, axis, 0).astype(np.int64)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_RESAMPLE_BITS - 1), np.int64)
    wshape = (n_out,) + (1,) * (src.ndim - 1)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, n_in - 1)   # weights past the edge are 0
        acc += src[idx] * weights[:, j].reshape(wshape)
    out = np.clip(acc >> _RESAMPLE_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(rgb: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [size, size, 3] uint8 as PIL's default
    ``Image.resize((size, size))`` gives it: bicubic with antialiasing,
    the horizontal pass first, each pass rounded to uint8."""
    if rgb.shape[1] != size:
        rgb = _resample_axis(rgb, size, axis=1)
    if rgb.shape[0] != size:
        rgb = _resample_axis(rgb, size, axis=0)
    return rgb


def load_image(path, size: int = 512, centered: bool = True) -> np.ndarray:
    """A PNG -> [1, size, size, 3] float32, in [-1, 1] with ``centered``
    (examples/inversion.py:16-22 semantics, NHWC), resized as PIL's
    ``resize`` does by default (`resize_bicubic`)."""
    arr = resize_bicubic(read_png(Path(path).read_bytes()), size).astype(np.float32)
    if centered:
        arr = arr / 127.5 - 1.0
    return arr[None]
