"""The port's MS-COCO generation pieces on the CPU (tiny_sd).

``cfgpp_tpu_torch/cli/text_to_mscoco.py`` as ``tests/test_cli.py:115-150``
checks the JAX CLI: the tail batch padded (no file for a padded slot),
``--resume`` (the finished batch untouched by mtime, ``num_images`` of the
rerun), per-sample ``record/<global_idx>/`` trees under ``--callbacks``, a
failed write counted out of ``num_images``; ``read_prompts`` equal to the
JAX CLI's.  Two ranks (two processes with ``RANK``/``WORLD_SIZE``) write
the same set of images as one process, each pixel within one uint8 level
(their UNet calls run at another batch, so the CPU's matmuls may round
otherwise).  ``text_to_img --callbacks``: the record PNGs named by the JAX
rule, and the image the one without callbacks.

``AsyncPngWriter``: pixels read back equal by PIL and by the port's
``load_image``; many concurrent submits; a failed write counted;
``close`` idempotent; pixels submitted with a ``ready`` event read only
after it.  ``save_image`` of a batch pixel for pixel the JAX package's
grid PNG.  ``parallel``: the rank's contiguous share, the torchrun
environment.  ``utils/log.py`` against ``cfgpp_tpu/utils/log.py``.
"""

import json
import logging
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cfgpp_tpu.cli import text_to_mscoco as jax_mscoco
from cfgpp_tpu.utils import img as jax_img
from cfgpp_tpu.utils import log as jax_log
from cfgpp_tpu_torch.cli import text_to_img, text_to_mscoco
from cfgpp_tpu_torch.parallel import DataParallel, data_parallel, shard_indices
from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
from cfgpp_tpu_torch.utils import log
from cfgpp_tpu_torch.utils.img import AsyncPngWriter, load_image, save_image

REPO = Path(__file__).resolve().parents[1]
NFE = 2


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for this module's tiny tensors: the test workers
    share the cores, and oversubscribed intra-op threads stall each small
    op at its barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def prompt_file(tmp_path):
    p = tmp_path / "prompts.txt"
    p.write_text("\n".join(f"tiny prompt {i}" for i in range(6)) + "\n")
    return p


def _args(wd, prompt_file, *extra):
    return ["--workdir", str(wd), "--model", "tiny_sd", "--method",
            "ddim_cfg++", "--NFE", str(NFE), "--cfg_guidance", "0.6",
            "--dtype", "float32", "--device", "cpu", "--prompt_dir",
            str(prompt_file), "--num_prompts", "6", "--batch_size", "4",
            "--resolution", "32", *extra]


def _pixels(path: Path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def _stats(wd: Path, name: str = "generation_stats.json") -> dict:
    return json.loads((wd / name).read_text())


def test_read_prompts_matches_jax(tmp_path):
    p = tmp_path / "p.txt"
    p.write_text("  a cat \n\n\tb dog\n c\n d\n")
    for limit in (2, 10):
        assert text_to_mscoco.read_prompts(str(p), limit) == \
            jax_mscoco.read_prompts(str(p), limit)


def test_tail_padding(tmp_path, prompt_file, capsys):
    """6 prompts at batch 4: one full batch and a tail padded to 4; all six
    land, the padded slots do not."""
    wd = tmp_path / "coco"
    text_to_mscoco.main(_args(wd, prompt_file))
    for i in range(6):
        assert _pixels(wd / f"{i:05d}.png").shape == (32, 32, 3)
    assert not (wd / "00006.png").exists() and not (wd / "00007.png").exists()
    assert _stats(wd)["num_images"] == 6
    assert "img/s" in capsys.readouterr().out


def test_resume(tmp_path, prompt_file):
    """--resume skips a batch whose PNGs all exist (checked by mtime) and
    regenerates the other; the rerun counts only its own images."""
    wd = tmp_path / "coco"
    text_to_mscoco.main(_args(wd, prompt_file))
    first = {i: (wd / f"{i:05d}.png").stat().st_mtime_ns for i in range(4)}
    before = _pixels(wd / "00005.png")
    (wd / "00005.png").unlink()
    text_to_mscoco.main(_args(wd, prompt_file, "--resume"))
    assert {i: (wd / f"{i:05d}.png").stat().st_mtime_ns
            for i in range(4)} == first
    assert np.array_equal(_pixels(wd / "00005.png"), before)
    assert _stats(wd)["num_images"] == 2


def test_callback_trees(tmp_path, prompt_file):
    wd = tmp_path / "coco"
    text_to_mscoco.main(_args(wd, prompt_file, "--callbacks", "draw_tweedie",
                              "draw_noisy", "--callback_frequency", "1"))
    ts = make_ddim_schedule(NFE).timesteps
    for i in range(8):          # the padded slots' trees too, as in JAX
        for sub, prefix in (("tweedie", "x0"), ("noisy", "xt")):
            names = sorted(p.name for p in
                           (wd / f"record/{i:05d}/{sub}").glob("*.png"))
            assert names == sorted(f"{prefix}_{int(t)}.png" for t in ts), (
                i, sub, names)


def test_failed_write_counted(tmp_path, prompt_file, capsys):
    """A PNG that cannot be written (its path is a directory) is counted
    as failed and left out of num_images."""
    wd = tmp_path / "coco"
    (wd / "00002.png").mkdir(parents=True)
    text_to_mscoco.main(_args(wd, prompt_file))
    assert _stats(wd)["num_images"] == 5
    out = capsys.readouterr().out
    assert "WARNING: 1 image writes failed" in out and "00002.png" in out


def test_two_ranks_match_one_process(tmp_path, prompt_file):
    """Ranks 0 and 1 of 2, as two processes: each writes its contiguous
    half of every batch; together the same files as one process, each
    pixel within one uint8 level."""
    one = tmp_path / "one"
    text_to_mscoco.main(_args(one, prompt_file))
    ranks = tmp_path / "ranks"
    code = ("import sys\n"
            "from cfgpp_tpu_torch.cli.text_to_mscoco import main\n"
            "main(sys.argv[1:])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *_args(ranks, prompt_file)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                 OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES=""))
        for r in (0, 1)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    pngs = sorted(p.name for p in ranks.glob("*.png"))
    assert pngs == sorted(p.name for p in one.glob("*.png"))
    for name in pngs:
        d = np.abs(_pixels(ranks / name).astype(int)
                   - _pixels(one / name).astype(int)).max()
        assert d <= 1, (name, d)
    # rank 0: 0, 1 and 4, 5; rank 1: 2, 3 (its tail slots 6, 7 are padding)
    assert [_stats(ranks, f"generation_stats.rank{r}.json")["num_images"]
            for r in (0, 1)] == [4, 2]
    assert not (ranks / "generation_stats.json").exists()


def test_unsplit_batch_leaves_other_ranks_idle(tmp_path, prompt_file,
                                               monkeypatch, capsys):
    """A batch that does not split over the ranks (or --no_mesh): rank 0
    generates every image, the others none."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "1")
    text_to_mscoco.main(_args(tmp_path / "coco", prompt_file))
    assert not (tmp_path / "coco").exists()
    assert "rank 0 generates every image" in capsys.readouterr().out
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    text_to_mscoco.main(_args(tmp_path / "coco", prompt_file, "--no_mesh"))
    assert _stats(tmp_path / "coco")["num_images"] == 6


def test_text_to_img_callbacks(tmp_path):
    base = ["--model", "tiny_sd", "--method", "ddim_cfg++", "--NFE", "3",
            "--cfg_guidance", "0.6", "--prompt", "a cat", "--dtype",
            "float32", "--device", "cpu", "--resolution", "32"]
    text_to_img.main(base + ["--workdir", str(tmp_path / "plain")])
    text_to_img.main(base + ["--workdir", str(tmp_path / "cb"), "--callbacks",
                             "draw_tweedie", "draw_noisy",
                             "--callback_frequency", "2"])
    ts = make_ddim_schedule(3).timesteps
    for sub, prefix in (("tweedie", "x0"), ("noisy", "xt")):
        names = sorted(p.name for p in (tmp_path / "cb/record" / sub).iterdir())
        assert names == sorted(f"{prefix}_{int(ts[i])}.png" for i in (0, 1))
    assert np.array_equal(_pixels(tmp_path / "cb/result/generated.png"),
                          _pixels(tmp_path / "plain/result/generated.png"))


def _want_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def test_writer_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    imgs = [rng.random((37, 53, 3), dtype=np.float32),
            rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)]
    with AsyncPngWriter(n_threads=2) as writer:
        for i, img in enumerate(imgs):
            writer.submit(tmp_path / f"sub/{i}.png", img)
        assert writer.wait() == 0
    for i, img in enumerate(imgs):
        want = img if img.dtype == np.uint8 else _want_u8(img)
        assert np.array_equal(_pixels(tmp_path / f"sub/{i}.png"), want)
    # load_image reads a square image at its own size without resampling
    square = tmp_path / "square.png"
    with AsyncPngWriter() as writer:
        writer.submit(square, imgs[0][:37, :37])
    assert np.array_equal(load_image(square, size=37, centered=False)[0],
                          _want_u8(imgs[0][:37, :37]).astype(np.float32))


def test_writer_copies_at_submit(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    with AsyncPngWriter(n_threads=1) as writer:
        writer.submit(tmp_path / "a.png", img)
        img[:] = 255
    assert _pixels(tmp_path / "a.png").max() == 0


def test_writer_many_concurrent_submits(tmp_path):
    """4 threads submit 48 images each to one writer, with a short switch
    interval; every file lands with its own pixels."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with AsyncPngWriter(n_threads=8) as writer:
            def submit(t):
                for i in range(48):
                    writer.submit(tmp_path / f"{t}_{i}.png",
                                  np.full((4, 6, 3), (t * 48 + i) % 256,
                                          np.uint8))
            threads = [threading.Thread(target=submit, args=(t,))
                       for t in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
                assert not th.is_alive()
            assert writer.wait() == 0
    finally:
        sys.setswitchinterval(old)
    for t in range(4):
        for i in range(48):
            px = _pixels(tmp_path / f"{t}_{i}.png")
            assert px.shape == (4, 6, 3) and (px == (t * 48 + i) % 256).all()


def test_writer_failure_counted_and_close_idempotent(tmp_path):
    (tmp_path / "file").write_text("x")
    writer = AsyncPngWriter(n_threads=2)
    writer.submit(tmp_path / "file/under_a_file.png", np.zeros((4, 4, 3)))
    writer.submit(tmp_path / "ok.png", np.zeros((4, 4, 3)))
    assert writer.wait() == 1
    assert writer.errors[0][0] == tmp_path / "file/under_a_file.png"
    writer.submit(tmp_path / "file/again.png", np.zeros((4, 4, 3)))
    assert writer.wait() == 2          # counted since the writer was made
    writer.close()
    writer.close()
    assert (tmp_path / "ok.png").is_file()
    with pytest.raises(RuntimeError):
        writer.submit(tmp_path / "late.png", np.zeros((4, 4, 3)))


def test_writer_reads_after_ready(tmp_path):
    """With ``ready`` the pixels are read only after ready.synchronize():
    here that call is what fills the buffer."""
    buf = np.zeros((4, 4, 3), np.uint8)

    class Ready:
        def synchronize(self):
            buf[:] = 200

    with AsyncPngWriter(n_threads=1) as writer:
        writer.submit(tmp_path / "r.png", buf, ready=Ready())
    assert (_pixels(tmp_path / "r.png") == 200).all()


@pytest.mark.parametrize("b,nrow", [(1, 8), (3, 2), (9, 8), (4, 4)])
def test_save_image_batch_matches_jax_grid(tmp_path, b, nrow):
    img = np.random.default_rng(b).random((b, 5, 7, 3), dtype=np.float32)
    save_image(img, tmp_path / "port.png", nrow=nrow)
    jax_img.save_image(img, tmp_path / "jax.png", nrow=nrow)
    assert np.array_equal(_pixels(tmp_path / "port.png"),
                          _pixels(tmp_path / "jax.png"))
    save_image(img, tmp_path / "port_n.png", normalize_img=True, nrow=nrow)
    jax_img.save_image(img, tmp_path / "jax_n.png", normalize_img=True,
                       nrow=nrow)
    assert np.array_equal(_pixels(tmp_path / "port_n.png"),
                          _pixels(tmp_path / "jax_n.png"))


def test_shard_indices():
    idx = list(range(8, 16))
    assert [shard_indices(idx, r, 4) for r in range(4)] == [
        [8, 9], [10, 11], [12, 13], [14, 15]]
    assert shard_indices(idx, 0, 1) == idx
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        shard_indices(idx, 0, 3)


def test_data_parallel_reads_torchrun_env(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert data_parallel() == DataParallel(0, 1, 0)
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    dp = data_parallel()
    assert (dp.rank, dp.world, dp.local_rank) == (5, 8, 1)
    assert str(dp.device) == "cuda:1"
    monkeypatch.setenv("RANK", "8")
    with pytest.raises(ValueError, match="no such rank"):
        data_parallel()


def test_log_helpers_match_jax(tmp_path):
    for mod, name in ((log, "port"), (jax_log, "jax")):
        wd = mod.create_workdir(tmp_path / name)
        assert wd == tmp_path / name and (wd / "result").is_dir()
        mod.save_floats([1, 0.5, np.float32(2.25)], wd / "f.txt")
    assert (tmp_path / "port/f.txt").read_text() == \
        (tmp_path / "jax/f.txt").read_text() == "1.0\n0.5\n2.25\n"
    gen = log.set_seed(3)
    a = np.random.rand(3)
    jax_log.set_seed(3)
    assert np.array_equal(a, np.random.rand(3))
    assert gen.initial_seed() == 3 and gen.device.type == "cpu"


def test_get_logger(tmp_path):
    name = "cfgpp_tpu_torch.test_get_logger"
    logger = log.get_logger(name, level=logging.WARNING,
                            logfile=str(tmp_path / "a.log"))
    assert log.get_logger(name, logfile=str(tmp_path / "a.log")) is logger
    assert logger.level == logging.INFO
    assert sum(isinstance(h, logging.FileHandler)
               for h in logger.handlers) == 1
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    assert "hello" in (tmp_path / "a.log").read_text()
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
