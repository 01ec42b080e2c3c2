"""The port's metric CLI against the JAX package's, on the same directories.

Both ``main``s run on the same files: PNG inputs that PIL writes, paired PNG
labels (the inputs with seeded noise), and JPEG labels that PIL writes in
mixed sizes (so both take Inception's host-resize path), with the weights
in the published layouts (``cfgpp_tpu_torch.tools.metric_synth``): the
InceptionV3 state dict as ``.pth`` and as ``.safetensors``, torchvision's
VGG16 and the LPIPS heads as ``.pth``, a combined CLIPModel as
``.safetensors`` with a BPE vocabulary.  The port runs with ``--device
cpu``.  The CLIP towers run at a tiny width on both sides (2 layers, width
64, 224^2 inputs, the 768-d projections), through ``monkeypatch`` of the
config names each package's functions import when called; the full width
is ``chip_smoke.py`` phase 12's.

The JSON keys are equal; ``psnr``, ``mse`` and ``n_pairs`` exactly;
``fid``, ``clip_fid``, ``clip_score`` and ``lpips`` within 1e-4 relative.
The weight-gated runs give the same ``null``s.  Without ``--device`` the
port's CLI refuses to run here, where there is no GPU.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

import cfgpp_tpu.cli.calculate_metrics as jax_cli
from cfgpp_tpu.configs import CLIPTextConfig as JaxCLIPTextConfig
from cfgpp_tpu.models.clip_vision import CLIPVisionConfig as JaxVisionConfig
from cfgpp_tpu_torch.cli import calculate_metrics as cli
from cfgpp_tpu_torch.configs import CLIPTextConfig
from cfgpp_tpu_torch.models.clip_vision import CLIPVisionConfig
from cfgpp_tpu_torch.tools import metric_synth
from cfgpp_tpu_torch.weights.safetensors_io import save_file

REL_TOL = 1e-4
EXACT = ("psnr", "mse", "n_pairs")
TINY_TEXT = dict(hidden_size=64, num_layers=2, num_heads=2,
                 intermediate_size=128)
TINY_VISION = dict(hidden_size=64, num_layers=2, num_heads=2,
                   intermediate_size=128)
PROMPTS = ["a cat on the mat", "an astronaut riding a horse",
           "two dogs in the snow"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread and one BLAS thread for this module: the test
    workers share the cores, and oversubscribed intra-op threads stall each
    op at its barrier (OpenBLAS's eigendecompositions of the FID's 2048^2
    covariances took 10x their one-thread time beside busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _smooth(w: int, h: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = rng.uniform(4, 20, 3)
    base = np.stack([128 + 100 * np.sin(xx / f[0] + yy / f[1]),
                     128 + 100 * np.cos(yy / f[2]), (xx * 3 + yy) % 256], -1)
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def _noisy(arr: np.ndarray, seed: int) -> np.ndarray:
    noise = np.random.default_rng(seed).integers(-8, 9, arr.shape)
    return np.clip(arr.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics_cli")
    d = {name: root / name for name in ("inputs", "paired", "mixed_in",
                                        "mixed_jpeg")}
    for p in d.values():
        p.mkdir()
    for i in range(3):
        arr = _smooth(64, 64, i)
        Image.fromarray(arr).save(d["inputs"] / f"{i:05d}.png")
        Image.fromarray(_noisy(arr, 10 + i)).save(d["paired"] / f"{i:05d}.png")
    for i, (w, h) in enumerate([(64, 48), (48, 80), (72, 72)]):
        arr = _smooth(w, h, 20 + i)
        Image.fromarray(arr).save(d["mixed_in"] / f"{i:05d}.png")
        Image.fromarray(_noisy(arr, 30 + i)).save(
            d["mixed_jpeg"] / f"{i:05d}.jpg", quality=85)
    inc = metric_synth.inception_state(0)
    torch.save(inc, root / "inception.pth")
    save_file(inc, root / "inception.safetensors")
    torch.save(metric_synth.vgg16_state(1), root / "vgg16.pth")
    torch.save(metric_synth.lpips_heads_state(2), root / "lpips.pth")
    save_file(metric_synth.clip_model_state(
        3, CLIPTextConfig(projection_dim=768, **TINY_TEXT),
        CLIPVisionConfig(**TINY_VISION)), root / "clip.safetensors")
    metric_synth.write_clip_vocab(root / "tokenizer")
    (root / "prompts.txt").write_text("\n".join(PROMPTS) + "\n")
    d.update({name: root / name for name in (
        "inception.pth", "inception.safetensors", "vgg16.pth", "lpips.pth",
        "clip.safetensors", "tokenizer", "prompts.txt")})
    d["root"] = root
    return d


@pytest.fixture
def tiny_clip(monkeypatch):
    """Both packages' CLIP configs at the tiny width."""
    monkeypatch.setattr("cfgpp_tpu.configs.CLIPTextConfig",
                        lambda **kw: JaxCLIPTextConfig(**TINY_TEXT, **kw))
    monkeypatch.setattr("cfgpp_tpu.models.clip_vision.CLIPVisionConfig",
                        lambda: JaxVisionConfig(**TINY_VISION))
    monkeypatch.setattr("cfgpp_tpu_torch.configs.CLIPTextConfig",
                        lambda **kw: CLIPTextConfig(**TINY_TEXT, **kw))
    monkeypatch.setattr("cfgpp_tpu_torch.models.clip_vision.CLIPVisionConfig",
                        lambda: CLIPVisionConfig(**TINY_VISION))


def _both(files, tag: str, args):
    """Run both CLIs; return (port JSON, JAX JSON)."""
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        path = files["root"] / f"{tag}_{name}.json"
        main([str(a) for a in args] + ["--out", str(path)] + extra)
        out[name] = json.loads(path.read_text())
    return out["port"], out["jax"]


def _assert_same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if key in EXACT or w is None:
            assert g == w, (key, g, w)
        else:
            assert abs(g - w) <= REL_TOL * abs(w), (key, g, w)


def test_all_metrics_paired_png(files, tiny_clip):
    got, want = _both(files, "all", [
        "--input_dir", files["inputs"], "--label_dir", files["paired"],
        "--inception_ckpt", files["inception.pth"],
        "--clip_ckpt", files["clip.safetensors"],
        "--prompts", files["prompts.txt"],
        "--tokenizer_dir", files["tokenizer"],
        "--vgg_ckpt", files["vgg16.pth"], "--lpips_ckpt", files["lpips.pth"]])
    _assert_same(got, want)
    assert got["n_pairs"] == 3 and np.isfinite(got["psnr"])
    assert all(got[k] is not None and got[k] > 0
               for k in ("fid", "clip_fid", "lpips"))
    assert 0 < got["clip_score"] <= 100


def test_mixed_size_jpeg_labels(files, tiny_clip):
    got, want = _both(files, "mixed", [
        "--input_dir", files["mixed_in"], "--label_dir", files["mixed_jpeg"],
        "--inception_ckpt", files["inception.safetensors"],
        "--clip_ckpt", files["clip.safetensors"],
        "--prompts", files["prompts.txt"],
        "--tokenizer_dir", files["tokenizer"]])
    _assert_same(got, want)
    assert got["lpips"] is None and got["fid"] > 0 and got["clip_score"] > 0


@pytest.mark.parametrize("gated", ["none", "prompts_only", "clip_no_prompts",
                                   "vgg_only"])
def test_weight_gated_nones(files, tiny_clip, gated):
    extra = {"none": [],
             "prompts_only": ["--prompts", files["prompts.txt"]],
             "clip_no_prompts": ["--clip_ckpt", files["clip.safetensors"]],
             "vgg_only": ["--vgg_ckpt", files["vgg16.pth"]]}[gated]
    got, want = _both(files, f"gated_{gated}", [
        "--input_dir", files["inputs"], "--label_dir", files["paired"]] + extra)
    _assert_same(got, want)
    assert got["fid"] is None and got["lpips"] is None
    assert got["clip_score"] is None


def test_port_refuses_cuda_without_gpu(files):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input_dir", str(files["inputs"]),
                  "--label_dir", str(files["paired"])])
