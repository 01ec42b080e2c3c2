"""Image IO helpers (host side), counterpart of ``cfgpp_tpu/utils/img.py``
(with ``to_np``, ``fft2d`` and ``ifft2d``) and of ``cfgpp_tpu/native``'s
`AsyncPngWriter` and `AsyncPngReader`.

PNGs are written and read with the standard library's zlib, and JPEGs read
by `cfgpp_tpu_torch.utils.jpeg`, so saving and loading an image needs no
imaging package.  `read_image` reads every standard PNG (greyscale, RGB,
palette, greyscale+alpha and RGBA at each of their bit depths, 1 to 16;
interlaced or not) and the JPEGs PIL reads with its defaults (baseline and
progressive, greyscale or YCbCr), each to the bit what PIL's
``convert("RGB")`` gives; any other format raises.  `resize` is PIL's
8-bit bicubic and bilinear resample.  `AsyncPngWriter` encodes and writes
on worker threads: ``zlib.compress`` and the file write release the GIL, so
the threads overlap each other and the caller without a native library.
`AsyncImageReader` decodes ahead of its consumer: PNGs on threads (zlib
releases the GIL), JPEGs in worker processes (the entropy decoder is a
Python loop that holds it).
"""

from __future__ import annotations

import multiprocessing
import os
import struct
import zlib
from concurrent.futures import (Future, ProcessPoolExecutor,
                                ThreadPoolExecutor)
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from cfgpp_tpu_torch.utils.jpeg import decode_jpeg, jpeg_size

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel: greyscale, RGB, palette,
# greyscale+alpha, RGBA; and the bit depths each may have
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
               6: (8, 16)}
# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_JPEG_SOI = b"\xff\xd8\xff"
# leading bytes of the formats read_image refuses, to name them
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"RIFF", "a RIFF container (WebP)"))


def to_np(x) -> np.ndarray:
    """A tensor (any device; bf16 read as f32, whose values it holds
    exactly) or an array-like -> a numpy array on the host."""
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


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
    [h, stride] uint8 from the inflated IDAT stream.  Runs of None, Sub and
    Up rows are undone a run at a time in numpy (uint8 sums wrap as the
    filters' modulo-256 sums do); Average and Paeth rows one byte at a
    time."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of pixel data, expected"
                         f" {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter type {int(kinds.max())}")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    cuts = (np.flatnonzero(kinds[1:] != kinds[:-1]) + 1).tolist()
    for a, b in zip([0] + cuts, cuts + [h]):
        kind, lines = int(kinds[a]), rows[a:b, 1:]
        if kind == 0:
            out[a:b] = lines
        elif kind == 1:      # Sub: + the byte one pixel to the left
            out[a:b] = np.cumsum(lines.reshape(b - a, -1, bpp), axis=1,
                                 dtype=np.uint8).reshape(b - a, stride)
        elif kind == 2:      # Up: + the byte above
            out[a:b] = np.cumsum(lines, axis=0, dtype=np.uint8) + prior
        else:                # Average, Paeth: sequential along the row
            for y in range(a, b):
                cur, up = bytearray(rows[y, 1:].tobytes()), prior.tobytes()
                for x in range(stride):
                    left = cur[x - bpp] if x >= bpp else 0
                    above = up[x]
                    if kind == 3:
                        pred = (left + above) >> 1
                    else:
                        c = up[x - bpp] if x >= bpp else 0
                        pa, pb = abs(above - c), abs(left - c)
                        pc = abs(left + above - 2 * c)
                        pred = left if pa <= pb and pa <= pc else (
                            above if pb <= pc else c)
                    cur[x] = (cur[x] + pred) & 255
                out[y] = prior = np.frombuffer(bytes(cur), np.uint8)
        prior = out[b - 1]
    return out


def _png_samples(rows: np.ndarray, width: int, ch: int,
                 depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] uint8 -> [h, width, ch] samples: uint8
    for depths 1-8 (unscaled), big-endian uint16 for depth 16."""
    h = rows.shape[0]
    n = width * ch
    if depth == 16:
        return rows.view(">u2")[:, :n].astype(np.uint16).reshape(h, width, ch)
    if depth < 8:            # samples packed from the most significant bit
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(axis=2, dtype=np.uint8)
    return rows[:, :n].reshape(h, width, ch)


def _png_pixels(raw: bytes, w: int, h: int, ch: int, depth: int,
                interlace: int) -> np.ndarray:
    """The inflated IDAT stream -> [h, w, ch] samples, the seven Adam7
    passes (each filtered as an image of its own) put in place when
    ``interlace``."""
    bits = ch * depth
    bpp = max(1, bits // 8)             # the filters' byte distance
    if not interlace:
        rows = _unfilter_rows(raw, h, (w * bits + 7) // 8, bpp)
        return _png_samples(rows, w, ch, depth)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:          # an empty pass has no bytes
            continue
        stride = (pw * bits + 7) // 8
        size = ph * (stride + 1)
        rows = _unfilter_rows(raw[pos:pos + size], ph, stride, bpp)
        out[y0::dy, x0::dx] = _png_samples(rows, pw, ch, depth)
        pos += size
    if pos != len(raw):
        raise ValueError(f"PNG: {len(raw)} bytes of interlaced pixel data,"
                         f" expected {pos}")
    return out


def read_png(data: bytes) -> np.ndarray:
    """A PNG of any standard colour type, bit depth and interlace ->
    [H, W, 3] uint8, to the bit PIL's ``Image.open(f).convert("RGB")``:

    - greyscale repeated over the three channels, alpha dropped, a tRNS
      chunk ignored (``convert("RGB")`` drops transparency);
    - grey at depths 1, 2 and 4 scaled to 8 bits as PIL's modes "1", "L;2"
      and "L;4" do (x 255, x 85, x 17);
    - palette images (any depth) looked up in PLTE, and an index past its
      last entry black, as PIL's palette is;
    - 16-bit grey as PIL reads it, through mode ``I;16``, whose RGB
      conversion clips at 255 (not the high byte): min(v, 255);
    - 16-bit grey+alpha, RGB and RGBA keep each sample's high byte (PIL's
      ``LA;16B``, ``RGB;16B`` and ``RGBA;16B`` raw modes);
    - Adam7-interlaced files de-interlaced."""
    if not data.startswith(_PNG_SIGNATURE):
        raise _unknown_format(data)
    pos, header, palette, idat = len(_PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += n + 12                      # length, tag, body, crc
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or no IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth not in _PNG_DEPTHS.get(colour, ()) or interlace > 1:
        raise ValueError(f"PNG: bit depth {depth}, colour type {colour},"
                         f" interlace {interlace} is no standard PNG format")
    ch = _PNG_CHANNELS[colour]
    px = _png_pixels(zlib.decompress(b"".join(idat)), w, h, ch, depth,
                     interlace)
    if colour == 3:
        if palette is None:
            raise ValueError("PNG: a palette image without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette[:len(palette) // 3 * 3], np.uint8)
        lut[:len(entries) // 3] = entries.reshape(-1, 3)[:256]
        return lut[px[..., 0]]
    if depth == 16:
        px = (np.minimum(px, 255) if colour == 0 else px >> 8).astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    return np.repeat(px[..., :1], 3, axis=-1) if ch < 3 else px[..., :3].copy()


def _unknown_format(data: bytes) -> ValueError:
    fmt = next((name for magic, name in _OTHER_FORMATS
                if data.startswith(magic)), "an unknown format")
    return ValueError(f"load_image reads PNG and JPEG files only; this file"
                      f" is {fmt}")


def read_image(path) -> np.ndarray:
    """A PNG or JPEG file -> [H, W, 3] uint8, PIL's ``convert("RGB")`` of
    it."""
    data = Path(path).read_bytes()
    if data.startswith(_JPEG_SOI):
        return decode_jpeg(data)
    return read_png(data)


def image_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG or JPEG from its header (IHDR, SOFn),
    without decoding the pixels."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
        if head.startswith(_PNG_SIGNATURE):
            return struct.unpack(">II", head[16:24])
        if not head.startswith(_JPEG_SOI):
            raise _unknown_format(head)
        try:
            return jpeg_size(head)
        except ValueError:          # a header past the first 64 KiB
            return jpeg_size(head + f.read())


_RESAMPLE_BITS = 22       # fraction bits of PIL's 8-bit resample weights


def _bicubic(x: float) -> float:
    """Pillow's bicubic_filter (a = -0.5)."""
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return 0.0


def _bilinear(x: float) -> float:
    """Pillow's bilinear_filter: the triangle of support 1."""
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def _resample_taps(n_in: int, n_out: int, resample: str):
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc (Resample.c)
    for one axis: the filter stretched by the downscale factor so that it
    also antialiases, the weights normalized in double precision and
    rounded to 22 fraction bits.  Per output index the first input index
    [n_out] and the integer weights [n_out, taps]."""
    kernel, filter_support = _FILTERS[resample]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(n_out, np.int64)
    weights = np.zeros((n_out, taps), np.int64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        k = [kernel((x + lo - center + 0.5) * ss) for x in range(hi - lo)]
        total = 0.0
        for w in k:
            total += w
        if total != 0.0:
            k = [w / total for w in k]
        first[i] = lo
        weights[i, :hi - lo] = [
            int(w * (1 << _RESAMPLE_BITS) + (-0.5 if w < 0 else 0.5))
            for w in k]
    return first, weights


def _resample_axis(px: np.ndarray, n_out: int, axis: int,
                   resample: str) -> np.ndarray:
    """One pass of PIL's 8-bit resample along ``axis`` of a uint8 image,
    with Pillow's 32-bit integer sums (ImagingResampleHorizontal_8bpc)."""
    n_in = px.shape[axis]
    first, weights = _resample_taps(n_in, n_out, resample)
    weights = weights.astype(np.int32)
    src = np.moveaxis(px, axis, 0)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_RESAMPLE_BITS - 1), np.int32)
    term = np.empty_like(acc)
    wshape = (n_out,) + (1,) * (src.ndim - 1)
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, n_in - 1)   # weights past the edge are 0
        np.multiply(src[idx], weights[:, j].reshape(wshape), out=term)
        acc += term
    out = np.clip(acc >> _RESAMPLE_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(rgb: np.ndarray, size: Tuple[int, int],
           resample: str = "bicubic") -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 for ``size = (w, h)``, as PIL's
    ``Image.resize(size, BICUBIC or BILINEAR)`` gives it: the horizontal
    pass first, each pass rounded to uint8, an axis of unchanged length
    left alone."""
    w, h = size
    if rgb.shape[1] != w:
        rgb = _resample_axis(rgb, w, axis=1, resample=resample)
    if rgb.shape[0] != h:
        rgb = _resample_axis(rgb, h, axis=0, resample=resample)
    return rgb


def load_image(path, size: int = 512, centered: bool = True) -> np.ndarray:
    """A PNG or JPEG -> [1, size, size, 3] float32, in [-1, 1] with
    ``centered`` (examples/inversion.py:16-22 semantics, NHWC), resized as
    PIL's ``resize((size, size))`` does by default (bicubic)."""
    arr = resize(read_image(path), (size, size)).astype(np.float32)
    if centered:
        arr = arr / 127.5 - 1.0
    return arr[None]


def fft2d(x: np.ndarray) -> np.ndarray:
    """Centered 2D FFT over the spatial dims of NHWC (legacy parity helper)."""
    return np.fft.fftshift(np.fft.fft2(x, axes=(1, 2)), axes=(1, 2))


def ifft2d(x: np.ndarray) -> np.ndarray:
    return np.fft.ifft2(np.fft.ifftshift(x, axes=(1, 2)), axes=(1, 2))


def _is_jpeg_name(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


def _read(path: str, transform: Optional[Callable]):
    px = read_image(path)
    return px if transform is None else transform(px)


class AsyncImageReader:
    """Decodes image files ahead of their consumer, counterpart of
    ``cfgpp_tpu/native``'s `AsyncPngReader`: `get(i)` returns the i-th
    path's `read_image`, passed through ``transform`` if one is given
    (blocking until its decode has ended), iteration returns them in order,
    and at most ``window`` decodes run ahead of the highest index read so
    far.  ``transform`` (a resize, a crop) runs in the worker beside the
    decode; for JPEGs it must pickle (a module-level function or a
    ``functools.partial`` of one).  ``.png`` and other files decode on
    ``n_threads`` threads; ``.jpg``/``.jpeg`` files in worker processes
    (one a core up to 8, never more than there are JPEGs), started at the
    first JPEG.  The processes come from a
    ``forkserver`` context: the server is a fresh interpreter that has
    imported this module, and each pool forks its workers from it, so the
    caller may have initialized CUDA and a second pool starts at once.  A
    decode's error is raised by the `get` that reads it.  `close`, or
    leaving the ``with`` block, stops the workers."""

    def __init__(self, paths, n_threads: int = 8, window: int = 64,
                 transform: Optional[Callable] = None):
        self._paths = [str(p) for p in paths]
        self._transform = transform
        self._n_threads = n_threads
        n_jpeg = sum(map(_is_jpeg_name, self._paths))
        self._n_processes = min(8, os.cpu_count() or 1, max(n_jpeg, 1))
        self._window = max(window, n_threads)
        self._threads: Optional[ThreadPoolExecutor] = None
        self._processes: Optional[ProcessPoolExecutor] = None
        self._pending: Dict[int, Future] = {}
        self._submitted = 0
        self._fill(0)

    def _pool(self, path: str):
        if _is_jpeg_name(path):
            if self._processes is None:
                ctx = multiprocessing.get_context("forkserver")
                ctx.set_forkserver_preload([__name__])
                self._processes = ProcessPoolExecutor(self._n_processes,
                                                      mp_context=ctx)
            return self._processes
        if self._threads is None:
            self._threads = ThreadPoolExecutor(self._n_threads,
                                               thread_name_prefix="imread")
        return self._threads

    def _fill(self, consumed: int) -> None:
        hi = min(consumed + self._window, len(self._paths))
        while self._submitted < hi:
            path = self._paths[self._submitted]
            self._pending[self._submitted] = self._pool(path).submit(
                _read, path, self._transform)
            self._submitted += 1

    def __len__(self) -> int:
        return len(self._paths)

    def get(self, i: int) -> np.ndarray:
        """[H, W, 3] uint8 of the i-th path (or its transform).  A result is
        handed out once; a second `get` of the same index decodes the file
        again."""
        self._fill(i + 1)
        future = self._pending.pop(i, None)
        if future is None:
            return _read(self._paths[i], self._transform)
        return future.result()

    def __iter__(self):
        for i in range(len(self._paths)):
            yield self.get(i)

    def close(self) -> None:
        for future in self._pending.values():
            future.cancel()
        self._pending.clear()
        for pool in (self._threads, self._processes):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        self._threads = self._processes = None

    def __enter__(self) -> "AsyncImageReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
