"""The port's PNG reader and ``load_image`` against cfgpp_tpu.utils.

``cfgpp_tpu.utils.load_image`` reads through PIL; the port reads PNGs with
zlib (the card's machine has no PIL) and resizes with PIL's bicubic
resample done in numpy.  Both are held exactly: at the file's own size, and
after a resize down, up and to a square from a non-square image (the
measured difference is 0 levels at every size tried, so the tolerance is
exact equality).  Each PNG row filter is written by this file's own encoder
and read back; each 8-bit colour mode comes from PIL's writer.  Every other
standard PNG format (palette with and without tRNS, bit depths 1, 2, 4 and
16, Adam7 interlace) is held bit for bit against PIL's ``convert("RGB")``
of the same bytes.  Other formats (and CMYK JPEGs) and PNGs outside the
standard raise ``ValueError``.
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
    """Formats other than PNG and JPEG, and a JPEG kind the decoder does not
    read (CMYK), raise and name the format."""
    path = tmp_path / "img.bin"
    img = Image.fromarray(_smooth(16, 16))
    if fmt == "JPEG":
        img.convert("CMYK").save(path, format=fmt)
        match = "CMYK JPEG"
    else:
        img.save(path, format=fmt)
        match = f"PNG and JPEG files only.*{name}"
    with pytest.raises(ValueError, match=match):
        load_image(path, size=16)


@pytest.mark.parametrize("make", ["palette", "16-bit"])
def test_other_png_kinds_raise(tmp_path, make):
    """PNGs outside the standard: a palette at bit depth 16 (palettes stop at
    8), and a 16-bit header over 8-bit rows (a writer's wrong depth)."""
    path = tmp_path / "img.png"
    if make == "palette":
        path.write_bytes(_png_any(np.zeros((4, 4, 1), np.uint16), 3, 16,
                                  palette=bytes(range(48))))
        match = "no standard PNG format"
    else:
        data = _png_any(_noise(16, 16), 2, 8)
        at = data.index(b"IHDR") + 12
        path.write_bytes(data[:at] + b"\x10" + data[at + 1:])
        match = "bytes of pixel data"
    with pytest.raises(ValueError, match=match):
        load_image(path, size=16)


# ---------------------------------------------------------------------------
# Every standard PNG format against PIL: palette (with and without tRNS),
# bit depths 1, 2, 4 and 16, and Adam7 interlace.  PIL writes what it can
# (palette at 8/4/2/1 bits, 1-bit and 16-bit grey); this file's encoder
# writes the rest (2- and 4-bit grey, 16-bit grey+alpha, RGB and RGBA, short
# palettes, every format interlaced), and PIL decodes the same bytes.

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """[h, stride] uint8 rows -> the filtered scanlines, row y under
    filters[y % n]."""
    px = rows.astype(np.int64)
    out = []
    for y in range(px.shape[0]):
        kind = filters[y % len(filters)]
        cur = px[y]
        prior = px[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:cur.size]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:cur.size]
        pred = [np.zeros_like(cur), left, prior, (left + prior) // 2][kind] \
            if kind < 4 else None
        if kind == 4:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _packed(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, stride] uint8 rows at ``depth`` bits."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _png_any(samples, colour, depth, palette=None, trns=None,
             interlace=False, filters=(0,)) -> bytes:
    """A PNG of [h, w, c] samples at any colour type and bit depth, Adam7
    interlaced when asked."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        data = b"".join(_filtered(_packed(samples[y0::dy, x0::dx], depth),
                                  bpp, filters)
                        for x0, y0, dx, dy in ADAM7
                        if samples[y0::dy, x0::dx].size)
    else:
        data = _filtered(_packed(samples, depth), bpp, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def _pil_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _check_equals_pil(path) -> np.ndarray:
    from cfgpp_tpu_torch.utils.img import image_size, read_image
    got = read_image(path)
    want = _pil_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_size(path) == (want.shape[1], want.shape[0])
    return got


def _own_file(colour, depth, h, w, seed, interlace, filters=(0,),
              trns=False, short_palette=False):
    """Seeded samples over the format's whole range, with its PLTE / tRNS."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, CHANNELS[colour]))
    if depth == 16:       # values at and around PIL's I;16 clip
        samples[0, : min(w, 6), 0] = [0, 1, 254, 255, 256, 65535][: min(w, 6)]
    palette = trn = None
    if colour == 3:
        n = max(1, (top + 1) // 2) if short_palette else top + 1
        palette = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        if trns:
            trn = bytes(rng.integers(0, 256, n).astype(np.uint8))
    elif trns:
        trn = struct.pack(">" + "H" * (3 if colour == 2 else 1),
                          *[int(v) & 0xFFFF for v in samples[0, 0, :3]])
    return _png_any(samples, colour, depth, palette, trn, interlace, filters)


OWN_FORMATS = [(0, 1), (0, 2), (0, 4), (0, 16), (2, 16), (3, 1), (3, 2),
               (3, 4), (3, 8), (4, 16), (6, 16), (0, 8), (2, 8), (4, 8), (6, 8)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("colour,depth", OWN_FORMATS)
def test_png_formats_equal_pil(tmp_path, colour, depth, interlace):
    """Each colour type at each of its bit depths, plain and Adam7, at an
    odd size (partial bytes at the row ends, every pass non-empty)."""
    path = tmp_path / "f.png"
    path.write_bytes(_own_file(colour, depth, 13, 11, seed=colour * 17 + depth,
                               interlace=interlace, filters=(4, 3, 2, 1, 0)))
    _check_equals_pil(path)


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 1), (1, 9), (8, 8), (9, 17)])
@pytest.mark.parametrize("colour,depth", [(3, 2), (0, 16), (6, 16), (0, 1)])
def test_adam7_small_sizes_equal_pil(tmp_path, colour, depth, hw):
    """Sizes at which some of Adam7's seven passes are empty."""
    path = tmp_path / "f.png"
    path.write_bytes(_own_file(colour, depth, *hw, seed=sum(hw), interlace=True,
                               filters=(1, 4)))
    _check_equals_pil(path)


@pytest.mark.parametrize("colour,depth", [(3, 1), (3, 2), (3, 4), (3, 8),
                                          (0, 8), (0, 16), (2, 8), (2, 16)])
@pytest.mark.parametrize("short", [False, True])
def test_trns_and_short_palettes_equal_pil(tmp_path, colour, depth, short):
    """A tRNS chunk (dropped by convert("RGB")); a palette with fewer
    entries than the indices reach (PIL reads black past the last)."""
    path = tmp_path / "f.png"
    path.write_bytes(_own_file(colour, depth, 7, 10, seed=depth, interlace=short,
                               trns=True, short_palette=short))
    _check_equals_pil(path)


@pytest.mark.parametrize("make", ["P", "P;4", "P;2", "P;1", "P+tRNS",
                                  "P+alpha tRNS", "1", "I;16", "I;16 small"])
def test_pil_written_pngs_equal_pil(tmp_path, make):
    """The files PIL's own writer makes: palettes (adaptive quantize to 256,
    16, 4 and 2 colours: 8, 4, 2 and 1 bits), with a one-index or a
    per-entry tRNS, 1-bit grey, and 16-bit grey (mode I;16)."""
    path = tmp_path / "f.png"
    rgb = Image.fromarray(_smooth(19, 23))
    if make.startswith("P"):
        colours = {"P;4": 16, "P;2": 4, "P;1": 2}.get(make, 256)
        im = rgb.quantize(colours)
        if make == "P+tRNS":
            im.save(path, transparency=3)
        elif make == "P+alpha tRNS":
            im.info["transparency"] = bytes(range(0, 256, 3))
            im.save(path)
        else:
            im.save(path)
        depth = {16: 4, 4: 2, 2: 1}.get(colours, 8)
        assert Image.open(path).mode == "P"
        assert open(path, "rb").read()[24] == depth
    elif make == "1":
        rgb.convert("1").save(path)
    else:
        top = 65535 if make == "I;16" else 300
        arr = np.random.default_rng(3).integers(0, top + 1, (19, 23))
        Image.fromarray(arr.astype(np.uint16)).save(path)
        assert Image.open(path).mode == "I;16"
    _check_equals_pil(path)


def test_async_reader_reads_the_new_formats(tmp_path):
    from cfgpp_tpu_torch.utils.img import AsyncImageReader
    paths = []
    for i, (colour, depth) in enumerate(OWN_FORMATS[:8]):
        path = tmp_path / f"{i}.png"
        path.write_bytes(_own_file(colour, depth, 6, 5, seed=i,
                                   interlace=i % 2 == 1))
        paths.append(path)
    with AsyncImageReader(paths, n_threads=3, window=4) as reader:
        got = list(reader)
    for path, px in zip(paths, got):
        np.testing.assert_array_equal(px, _pil_rgb(path))


def test_load_image_palette_equals_jax(tmp_path):
    """``load_image`` of an interlaced palette file, resized, against the
    JAX package's PIL route."""
    path = tmp_path / "f.png"
    path.write_bytes(_own_file(3, 8, 40, 30, seed=9, interlace=True))
    np.testing.assert_array_equal(load_image(path, size=24),
                                  jax_load_image(path, size=24))
