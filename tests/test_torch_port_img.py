"""The port's PNG reader and ``load_image`` against cfgpp_tpu.utils.

``cfgpp_tpu.utils.load_image`` reads through PIL; the port reads PNGs with
zlib (the card's machine has no PIL) and resizes with PIL's bicubic
resample done in numpy.  Both are held exactly: at the file's own size, and
after a resize down, up and to a square from a non-square image (the
measured difference is 0 levels at every size tried, so the tolerance is
exact equality).  Each PNG row filter is written by this file's own encoder
and read back; each colour mode comes from PIL's writer.  Other formats
raise ``ValueError`` and name the format.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cfgpp_tpu.utils import load_image as jax_load_image
from cfgpp_tpu_torch.utils.img import load_image, read_png, save_image


def _smooth(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([128 + 100 * np.sin(xx / 9.0), 128 + 100 * np.cos(yy / 13.0),
                     (xx + yy) % 256], -1).astype(np.uint8)


def _noise(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_own_size_equals_pil(tmp_path, mode):
    ch = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    arr = _noise(32, 32, ch)
    path = tmp_path / "img.png"
    Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(path)
    for centered in (True, False):
        got = load_image(path, size=32, centered=centered)
        want = jax_load_image(path, size=32, centered=centered)
        assert got.dtype == want.dtype == np.float32 and got.shape == (1, 32, 32, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [7, 16, 64, 200, 256, 512])
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_resize_equals_pil(tmp_path, kind, size):
    """300x200 -> size^2: down on both axes, down on one and up on the
    other, up on both."""
    arr = _smooth(300, 200) if kind == "smooth" else _noise(300, 200)
    path = tmp_path / "img.png"
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(load_image(path, size=size),
                                  jax_load_image(path, size=size))


def _png(rows: np.ndarray, colour: int, filters) -> bytes:
    """A PNG of [h, w, c] uint8 with row i written under filters[i % n]."""
    h, w, c = rows.shape
    px = rows.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = px[y]
        prior = px[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
@pytest.mark.parametrize("colour,ch", [(2, 3), (6, 4), (0, 1), (4, 2)])
def test_row_filters_read_right(tmp_path, filters, colour, ch):
    arr = _noise(9, 11, ch, seed=len(filters) + colour)
    data = _png(arr, colour, filters)
    want = np.repeat(arr[..., :1], 3, -1) if ch < 3 else arr[..., :3]
    np.testing.assert_array_equal(read_png(data), want)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    # the encoder above writes what PIL reads the same way
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), want)


def test_save_then_load_round_trip(tmp_path):
    img = np.random.default_rng(1).uniform(0, 1, (1, 24, 24, 3)).astype(np.float32)
    save_image(img, tmp_path / "x.png")
    got = load_image(tmp_path / "x.png", size=24, centered=False)
    np.testing.assert_array_equal(got, (img * 255.0 + 0.5).astype(np.uint8))


@pytest.mark.parametrize("fmt,name", [("JPEG", "JPEG"), ("GIF", "GIF"),
                                      ("BMP", "BMP"), ("TIFF", "TIFF")])
def test_other_formats_raise(tmp_path, fmt, name):
    path = tmp_path / "img.bin"
    Image.fromarray(_smooth(16, 16)).save(path, format=fmt)
    with pytest.raises(ValueError, match=f"PNG files only.*{name}"):
        load_image(path, size=16)


@pytest.mark.parametrize("make", ["palette", "16-bit"])
def test_other_png_kinds_raise(tmp_path, make):
    path = tmp_path / "img.png"
    if make == "palette":
        Image.fromarray(_smooth(16, 16)).convert("P").save(path)
    else:
        Image.fromarray(np.zeros((16, 16), np.uint16)).save(path)
    with pytest.raises(ValueError, match="load_image reads 8-bit"):
        load_image(path, size=16)
