"""The port's copies of the JAX package's numpy-only modules, held equal.

``cfgpp_tpu_torch/configs.py``, ``schedules/ddim.py``,
``schedules/karras.py`` and ``weights/tokenizer.py`` are copies of their
``cfgpp_tpu`` namesakes, so that the port imports nothing of the JAX
package.  Each test compares the copy with the original on the same inputs:
every bundle config field by field, the DDIM tables array by array, the
Karras helpers' outputs, and token ids from the hash fallback and from a
small BPE vocabulary.  The last test imports every
module of the port in a fresh interpreter and finds neither the JAX
package nor jax, jaxlib or flax loaded.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cfgpp_tpu import configs as jax_configs
from cfgpp_tpu.schedules import ddim as jax_ddim
from cfgpp_tpu.schedules import karras as jax_karras
from cfgpp_tpu.weights import tokenizer as jax_tokenizer
from cfgpp_tpu_torch import configs
from cfgpp_tpu_torch.schedules import ddim, karras
from cfgpp_tpu_torch.weights import tokenizer

REPO = Path(__file__).resolve().parents[1]
PROMPTS = ["", "a photograph of an astronaut riding a horse",
           "Snow_leopard on a rock, 4K!", "  two   spaces\tand a tab  "]


def test_bundle_names_equal():
    assert sorted(configs._PRESETS) == sorted(jax_configs._PRESETS)


@pytest.mark.parametrize("name", sorted(jax_configs._PRESETS))
def test_bundle_config_equal(name):
    got = dataclasses.asdict(configs.get_bundle_config(name))
    want = dataclasses.asdict(jax_configs.get_bundle_config(name))
    assert got == want


def test_unknown_bundle_raises_alike():
    for mod in (configs, jax_configs):
        with pytest.raises(ValueError, match="unknown model"):
            mod.get_bundle_config("sd9")


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("nfe", [50, 25, 4])
def test_ddim_schedule_equal(nfe, spacing):
    got = ddim.make_ddim_schedule(nfe, timestep_spacing=spacing)
    want = jax_ddim.make_ddim_schedule(nfe, timestep_spacing=spacing)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name
    assert np.array_equal(got.sigmas_ve, want.sigmas_ve)
    assert [got.alpha(t) for t in (-1, 0, 1, 999)] == [
        want.alpha(t) for t in (-1, 0, 1, 999)]


def _karras_cases():
    sig = ddim.make_ddim_schedule(50).sigmas_ve
    probe = np.array([0.0292, 0.5, 1.0, 3.7, 14.6])
    return [
        ("append_zero", (np.array([3.0, 2.0, 1.0]),), {}),
        ("get_sigmas_karras", (50, float(sig.min()), float(sig.max())), {}),
        ("get_sigmas_karras", (4, 0.1, 10.0), dict(rho=3.0)),
        ("get_ancestral_step", (14.6, 9.7), {}),
        ("get_ancestral_step", (1.0, 0.0), {}),
        ("get_ancestral_step", (2.0, 1.5), dict(eta=0.0)),
        ("get_ancestral_step", (2.0, 1.5), dict(eta=0.5)),
        ("timestep_log_nearest", (probe, np.log(sig)), {}),
        ("timestep_log_nearest", (3.7, np.log(sig)), {}),
        ("sigma_to_t_linear", (probe, sig), dict(quantize=True)),
        ("sigma_to_t_linear", (probe, sig), dict(quantize=False)),
        ("calculate_input_scale", (probe,), {}),
        ("calculate_input_scale", (14.6,), {}),
    ]


@pytest.mark.parametrize("case", range(len(_karras_cases())))
def test_karras_functions_equal(case):
    name, args, kw = _karras_cases()[case]
    got, want = (r if isinstance(r, tuple) else (r,) for r in (
        getattr(karras, name)(*args, **kw), getattr(jax_karras, name)(*args, **kw)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), (name, a, b)


def test_karras_names_equal():
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("_")  # noqa: E731
                              and callable(getattr(m, n))
                              and getattr(m, n).__module__ == m.__name__)
    assert public(karras) == public(jax_karras)


@pytest.mark.parametrize("kw", [{}, dict(vocab_size=1000, eos_token_id=999),
                                dict(pad_token_id=0)])
def test_hash_tokenizer_ids_equal(kw):
    got = tokenizer.HashTokenizer(**kw)(PROMPTS)
    want = jax_tokenizer.HashTokenizer(**kw)(PROMPTS)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _tiny_vocab(tmp_path: Path) -> Path:
    """A BPE vocabulary over the bytes and a few merges of the prompts."""
    byte_chars = list(jax_tokenizer._bytes_to_unicode().values())
    merges = [("a", "s"), ("t", "r"), ("o", "n</w>"), ("h", "o"),
              ("r", "o"), ("c", "k</w>"), ("s", "n"), ("sn", "o")]
    vocab = byte_chars + [c + "</w>" for c in byte_chars]
    vocab += ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (tmp_path / "vocab.json").write_text(
        json.dumps({tok: i for i, tok in enumerate(vocab)}))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return tmp_path


def test_clip_tokenizer_ids_equal(tmp_path):
    d = _tiny_vocab(tmp_path)
    got = tokenizer.load_tokenizer(str(d))
    want = jax_tokenizer.load_tokenizer(str(d))
    assert isinstance(got, tokenizer.CLIPTokenizer)
    ids = got(PROMPTS)
    assert np.array_equal(ids, want(PROMPTS))
    assert len(set(ids[1].tolist())) > 10   # the BPE ran, not only padding


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cfgpp_tpu_torch\n"
        "import chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cfgpp_tpu_torch.__path__, 'cfgpp_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) > 25, names\n"
        "for new in ('cfgpp_tpu_torch.schedules.karras',\n"
        "            'cfgpp_tpu_torch.cli.inversion',\n"
        "            'cfgpp_tpu_torch.cli.text_to_mscoco',\n"
        "            'cfgpp_tpu_torch.engine.callbacks',\n"
        "            'cfgpp_tpu_torch.parallel',\n"
        "            'cfgpp_tpu_torch.utils.log',\n"
        "            'cfgpp_tpu_torch.engine.pipeline',\n"
        "            'cfgpp_tpu_torch.solvers.registry',\n"
        "            'cfgpp_tpu_torch.tools.profile_requests'):\n"
        "    assert new in names, new\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('cfgpp_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
