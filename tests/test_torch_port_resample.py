"""PIL's resampling in the port, and the metric loaders built on it, against
PIL and the JAX package.

``cfgpp_tpu_torch.utils.img.resize`` is PIL's 8-bit ``Image.resize`` with
the BICUBIC and BILINEAR filters (Resample.c: the filter stretched by the
downscale factor, 22-bit weights, the horizontal pass first): equal to PIL
exactly, for non-square targets up and down.  The two metric loaders that
use it are held against the JAX package's own code, run with its tower
replaced by a function that hands back its input pixels:
``inception_features``' mixed-size load (PIL bilinear to 299x299, then
/255; ``cfgpp_tpu/metrics/inception.py:254-259``) and the uniform one, on
PNGs and JPEGs; ``clip_image_features``' ``load224`` (the shortest side to
224 by PIL bicubic, Python's ``round``, the centre crop;
``cfgpp_tpu/metrics/clip_score.py:119-131``) at 640x480, 480x640, 224x224
and 300x225.  Both sides read the files (PIL there, the port's decoders
here) and their pixels must be equal.
"""

from importlib import import_module

import numpy as np
import pytest
from PIL import Image

import cfgpp_tpu.metrics.inception as jax_inception
import cfgpp_tpu.models.clip_vision as jax_clip_vision
import cfgpp_tpu_torch.metrics.inception as inception
import cfgpp_tpu_torch.models.clip_vision as clip_vision
from cfgpp_tpu_torch.utils.img import resize

# the packages export a function of the module's name
jax_clip_score = import_module("cfgpp_tpu.metrics.clip_score")
clip_score = import_module("cfgpp_tpu_torch.metrics.clip_score")

PIL_FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}
CASES = [((300, 200), (299, 299)), ((300, 200), (224, 171)),
         ((300, 200), (171, 224)), ((64, 48), (299, 299)),
         ((640, 480), (299, 299)), ((480, 640), (224, 299)),
         ((37, 53), (7, 5)), ((37, 53), (640, 33)), ((5, 3), (299, 299))]


def _noise(w: int, h: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("resample", sorted(PIL_FILTERS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}"
                         f"-to-{c[1][0]}x{c[1][1]}")
def test_resize_equals_pil(case, resample):
    (w, h), size = case
    arr = _noise(w, h)
    want = np.asarray(Image.fromarray(arr).resize(size, PIL_FILTERS[resample]))
    got = resize(arr, size, resample)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pixels_back(px):
    """A stand-in tower: each image's pixels, flattened."""
    return px.reshape(px.shape[0], -1)


def _write(paths_dir, sizes, fmt: str):
    paths = []
    for i, (w, h) in enumerate(sizes):
        p = paths_dir / f"{i:05d}.{fmt}"
        Image.fromarray(_noise(w, h, seed=i)).save(
            p, **({"quality": 90} if fmt == "jpg" else {}))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("fmt", ["png", "jpg"])
@pytest.mark.parametrize("sizes", [[(64, 48)] * 3,
                                   [(640, 480), (480, 640), (299, 299)]],
                         ids=["uniform", "mixed"])
def test_inception_load_equals_jax(tmp_path, monkeypatch, fmt, sizes):
    paths = _write(tmp_path, sizes, fmt)
    monkeypatch.setattr(jax_inception, "_cached_extractor",
                        lambda path: _pixels_back)
    monkeypatch.setattr(inception, "_cached_extractor",
                        lambda path, device: _pixels_back)
    want = jax_inception.inception_features(paths, "unused.pth", batch=2)
    got = inception.inception_features(paths, "unused.pth", batch=2,
                                       device="cpu")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(640, 480), (480, 640), (224, 224),
                                  (300, 225)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_load224_equals_jax(tmp_path, monkeypatch, size):
    (tmp_path / "jpg").mkdir()
    paths = _write(tmp_path, [size, size], "png") \
        + _write(tmp_path / "jpg", [size], "jpg")
    monkeypatch.setattr(jax_clip_score, "_cached_vision_extractor",
                        lambda path: _pixels_back)
    monkeypatch.setattr(jax_clip_vision, "preprocess_for_clip", lambda x: x)
    monkeypatch.setattr(clip_score, "_cached_vision_extractor",
                        lambda path, device: _pixels_back)
    monkeypatch.setattr(clip_vision, "preprocess_for_clip", lambda x: x)
    want = jax_clip_score.clip_image_features(paths, "unused.safetensors")
    got = clip_score.clip_image_features(paths, "unused.safetensors",
                                         device="cpu")
    np.testing.assert_array_equal(got, want)
    # and the port's crop itself, unnormalized
    px = clip_score.load224(np.asarray(Image.open(paths[0]).convert("RGB")))
    assert px.shape == (224, 224, 3) and px.dtype == np.float32
    row = px.reshape(1, -1)
    np.testing.assert_array_equal(
        row / np.linalg.norm(row, axis=-1, keepdims=True), want[:1])
