"""The helpers the JAX package exports, ported: ``fft2d``, ``ifft2d``,
``to_np``, ``make_gif``, the ``utils`` name list and ``python -m
cfgpp_tpu_torch.solvers``; and the CLIs' TF32 switch under ``--dtype
float32``.

``fft2d`` / ``ifft2d`` are the JAX numpy code, held equal array for array.
``make_gif`` writes GIF89a itself (the card's machine has no PIL): PIL
reads its file back with the frame count, ``duration`` and ``loop`` of the
GIF PIL's own writer makes from the same frames (the JAX ``make_gif``), and
frames of at most 256 colours decode exactly; frames of more come back
within half a step of the writer's 8 x 8 x 4 colour cube.
"""

import argparse
import io
import runpy

import numpy as np
import pytest
import torch
from PIL import Image

import cfgpp_tpu.utils as jax_utils
import cfgpp_tpu_torch.utils as utils
from cfgpp_tpu.utils import img as jax_img
from cfgpp_tpu.utils import log as jax_log
from cfgpp_tpu_torch.utils import img, log


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this module's tiny tensors: the test workers
    share the cores, and oversubscribed intra-op threads stall each small
    op at its barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_utils_export_the_jax_names():
    assert utils.__all__ == jax_utils.__all__
    assert all(callable(getattr(utils, name)) for name in utils.__all__)


@pytest.mark.parametrize("shape", [(1, 8, 8, 3), (2, 5, 7, 4), (3, 16, 9, 1)])
@pytest.mark.parametrize("complex_in", [False, True])
def test_fft2d_ifft2d_equal_jax(shape, complex_in):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape)
    if complex_in:
        x = x + 1j * rng.standard_normal(shape)
    for name in ("fft2d", "ifft2d"):
        got, want = getattr(img, name)(x), getattr(jax_img, name)(x)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    np.testing.assert_allclose(img.ifft2d(img.fft2d(x)), x, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.int64])
def test_to_np_on_tensors(dtype):
    """bf16 (which numpy lacks) comes out as f32 holding the same values;
    other dtypes keep theirs."""
    t = (torch.arange(-6, 6).reshape(3, 4) * 0.37).to(dtype)
    got = img.to_np(t)
    assert isinstance(got, np.ndarray) and got.shape == (3, 4)
    want_dtype = np.float32 if dtype == torch.bfloat16 else \
        torch.empty(0, dtype=dtype).numpy().dtype
    assert got.dtype == want_dtype
    assert torch.equal(torch.from_numpy(got).to(dtype), t)


def test_to_np_on_arrays_equals_jax():
    for x in (np.arange(6.0).reshape(2, 3), [1, 2, 3], 2.5,
              np.zeros((0, 4), np.float32)):
        got, want = img.to_np(x), jax_img.to_np(x)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    t = torch.ones(2, requires_grad=True) * 2
    assert np.array_equal(img.to_np(t), [2.0, 2.0])


def test_solvers_main_prints_what_jax_prints(capsys):
    runpy.run_module("cfgpp_tpu.solvers", run_name="__main__")
    want = capsys.readouterr().out
    runpy.run_module("cfgpp_tpu_torch.solvers", run_name="__main__")
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 2
    import cfgpp_tpu_torch.solvers.__main__  # noqa: F401  (prints nothing)
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------- GIF

def _frames(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "palette":               # <= 256 colours a frame
        pal = rng.integers(0, 256, (rng.integers(2, 257), 3)).astype(np.uint8)
        return [pal[rng.integers(0, len(pal), (21, 34))] for _ in range(n)]
    if kind == "few":                   # 1-3 colours (the smallest tables)
        return [np.full((9, 5, 3), 40 * i, np.uint8) for i in range(n)]
    return [rng.integers(0, 256, (30, 17, 3)).astype(np.uint8)
            for _ in range(n)]          # > 256 colours


def _write_frames(tmp_path, frames):
    paths = []
    for i, f in enumerate(frames):
        path = tmp_path / f"{i:03d}.png"
        Image.fromarray(f).save(path)
        paths.append(path)
    return paths


def _read_gif(path):
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
        return im.n_frames, im.info.get("duration"), im.info.get("loop"), frames


@pytest.mark.parametrize("duration", [100, 40, 75])
@pytest.mark.parametrize("kind,n", [("palette", 4), ("few", 3), ("noise", 3),
                                    ("palette", 1)])
def test_make_gif_reads_back_as_pils(tmp_path, kind, n, duration):
    frames = _frames(kind, n, seed=n + duration)
    paths = _write_frames(tmp_path, frames)
    log.make_gif(paths, tmp_path / "port.gif", duration=duration)
    jax_log.make_gif(paths, tmp_path / "pil.gif", duration=duration)
    got, want = _read_gif(tmp_path / "port.gif"), _read_gif(tmp_path / "pil.gif")
    assert got[:3] == want[:3] and got[0] == n
    for f, back in zip(frames, got[3]):
        if kind == "noise":
            assert np.abs(back.astype(int) - f).max() <= 43
        else:
            np.testing.assert_array_equal(back, f)


def test_gif_lzw_table_resets(tmp_path):
    """A frame long enough to fill the 4096-code table many times over, at
    every colour-table size, decodes exactly."""
    rng = np.random.default_rng(11)
    for colours in (2, 3, 16, 200, 256):
        pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
        frame = pal[rng.integers(0, colours, (160, 150))]
        frame[:40] = pal[0]                       # long runs too
        data = log.gif_bytes([frame], duration=10)
        with Image.open(io.BytesIO(data)) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), frame)


def test_make_gif_of_nothing_writes_nothing(tmp_path):
    log.make_gif([], tmp_path / "none.gif")
    assert not (tmp_path / "none.gif").exists()


# ------------------------------------------------------- --dtype float32

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float32_cli_turns_tf32_off(dtype, monkeypatch, tmp_path):
    """``build_engine`` (every generation CLI) and ``parity_check`` turn
    cuDNN's and cuBLAS's TF32 off under --dtype float32 and leave torch's
    defaults under bf16."""
    from cfgpp_tpu_torch.cli import common, parity_check

    def build_engine():
        common.build_engine(argparse.Namespace(
            dtype=dtype, ckpt_dir=None, model="tiny_sd", device="cpu",
            light_ckpt=None, quant=None, method="ddim", NFE=2))

    def parity_check_main():       # stops at the missing dump, after the switch
        with pytest.raises(FileNotFoundError):
            parity_check.main(["--dump", str(tmp_path / "none.npz"),
                               "--ckpt_dir", str(tmp_path), "--device", "cpu",
                               "--dtype", dtype])

    for run in (build_engine, parity_check_main):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        run()
        on = dtype == "bfloat16"
        assert torch.backends.cudnn.allow_tf32 is on
        assert torch.backends.cuda.matmul.allow_tf32 is on
