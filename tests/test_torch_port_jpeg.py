"""The port's JPEG decoder and image reading against PIL and the JAX package.

``cfgpp_tpu_torch.utils.jpeg.decode_jpeg`` must give, bit for bit, what
``np.asarray(Image.open(f).convert("RGB"))`` gives (PIL's libjpeg-turbo
with its defaults: the ISLOW IDCT, fancy upsampling, the fixed-point YCbCr
tables).  PIL writes a grid of files: qualities 50, 75 and 95; 4:4:4,
4:2:2 and 4:2:0 subsampling and greyscale; progressive; restart intervals
in blocks and in rows; sizes from 1x1 to 640x480 and 480x640; an EXIF
orientation tag (not applied, as ``convert("RGB")`` does not apply it).
The header sizes equal PIL's.  The kinds the decoder refuses raise and name
the format.  ``load_image`` of a JPEG equals the JAX ``load_image``; the
committed fixtures' stored decodes equal PIL's; `AsyncImageReader` hands
back what `read_image` gives, in order, PNGs and JPEGs mixed.
"""

import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cfgpp_tpu.utils import load_image as jax_load_image
from cfgpp_tpu_torch.utils.img import (AsyncImageReader, image_size,
                                       load_image, read_image, read_png)
from cfgpp_tpu_torch.utils.jpeg import decode_jpeg, jpeg_size

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
SIZES = [(1, 1), (7, 9), (17, 33), (65, 48), (640, 480), (480, 640)]
KINDS = {
    "q75_444": dict(quality=75, subsampling="4:4:4"),
    "q75_422": dict(quality=75, subsampling="4:2:2"),
    "q75_420": dict(quality=75, subsampling="4:2:0"),
    "grey": dict(quality=75),
    "progressive_420": dict(quality=75, progressive=True),
    "progressive_444": dict(quality=75, progressive=True, subsampling="4:4:4"),
    "restart_blocks": dict(quality=75, restart_marker_blocks=3),
    "restart_rows": dict(quality=75, restart_marker_rows=1),
}
QUALITY_SIZES = [(65, 48), (640, 480)]


def _content(w: int, h: int, seed: int = 0) -> np.ndarray:
    """Smooth waves plus noise: every coefficient band gets some energy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / 9.0 + yy / 17.0),
                     128 + 90 * np.cos(yy / 13.0), (xx + yy) % 256], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _jpeg(w: int, h: int, kind: str = "q75_420", **extra) -> bytes:
    opts = dict(KINDS[kind], **extra)
    img = Image.fromarray(_content(w, h))
    if kind == "grey":
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_decodes_like_pil(data: bytes) -> None:
    got, want = decode_jpeg(data), _pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert jpeg_size(data) == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_equals_pil(size, kind):
    _assert_decodes_like_pil(_jpeg(*size, kind))


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("size", QUALITY_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_equals_pil_at_quality(size, quality):
    _assert_decodes_like_pil(_jpeg(*size, quality=quality))


def test_exif_orientation_not_applied():
    exif = Image.Exif()
    exif[0x0112] = 6                                   # rotate 90 CW on show
    data = _jpeg(40, 24, exif=exif.tobytes())
    assert Image.open(io.BytesIO(data)).getexif()[0x0112] == 6
    _assert_decodes_like_pil(data)
    assert decode_jpeg(data).shape == (24, 40, 3)


def test_cmyk_refused(tmp_path):
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(_content(16, 16)).convert("CMYK").save(path)
    with pytest.raises(ValueError, match="CMYK JPEG"):
        read_image(path)


def _patched_frame(data: bytes, marker: int = None, precision: int = None):
    """A baseline JPEG with its SOF0 marker or sample precision changed."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("marker,precision,name", [
    (0xC9, None, "arithmetic-coded"), (0xC3, None, "lossless"),
    (0xC5, None, "hierarchical"), (None, 12, "12-bit")])
def test_other_jpeg_kinds_refused(marker, precision, name):
    data = _patched_frame(_jpeg(16, 16), marker, precision)
    with pytest.raises(ValueError, match=name):
        decode_jpeg(data)


@pytest.mark.parametrize("size", [16, 64])
def test_load_image_jpeg_equals_jax(tmp_path, size):
    path = tmp_path / "img.jpg"
    path.write_bytes(_jpeg(65, 48, "q75_420"))
    for centered in (True, False):
        np.testing.assert_array_equal(
            load_image(path, size=size, centered=centered),
            jax_load_image(path, size=size, centered=centered))


def test_image_size_from_headers(tmp_path):
    png, jpg = tmp_path / "a.png", tmp_path / "b.jpg"
    Image.fromarray(_content(31, 17)).save(png)
    # an APP segment before the frame header pushes SOF past 64 KiB
    jpg.write_bytes(_jpeg(23, 45, "q75_420",
                          icc_profile=bytes(range(256)) * 300))
    assert image_size(png) == (31, 17)
    assert image_size(jpg) == (23, 45)


def test_fixtures_equal_pil():
    """The committed fixtures: PIL's decode equals the stored one (made by
    tests/make_jpeg_fixtures.py), and so does the port's."""
    jpgs = sorted(FIXTURES.glob("*.jpg"))
    assert len(jpgs) == 4
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 1.5e6, total
    for jpg in jpgs:
        stored = read_png(jpg.with_suffix(".png").read_bytes())
        pil = np.asarray(Image.open(jpg).convert("RGB"))
        np.testing.assert_array_equal(stored, pil)
        np.testing.assert_array_equal(read_image(jpg), pil)


def test_async_reader_order_window_and_errors(tmp_path):
    paths = []
    for i in range(7):
        w, h = 20 + i, 12 + 2 * i
        if i % 2:
            p = tmp_path / f"{i}.jpg"
            p.write_bytes(_jpeg(w, h, "q75_420" if i % 3 else "progressive_420"))
        else:
            p = tmp_path / f"{i}.png"
            Image.fromarray(_content(w, h, seed=i)).save(p)
        paths.append(p)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    want = [read_image(p) for p in paths]
    with AsyncImageReader(paths + [bad], n_threads=2, window=2) as reader:
        assert len(reader) == 8
        got = [reader.get(i) for i in range(7)]
        with pytest.raises(ValueError):
            reader.get(7)
        again = reader.get(3)                 # a second get decodes again
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(again, want[3])
    with AsyncImageReader(paths[:3], n_threads=2) as reader:
        for a, b in zip(reader, want[:3]):
            np.testing.assert_array_equal(a, b)
