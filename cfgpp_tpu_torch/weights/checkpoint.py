"""The port's native bundle checkpoint.  Counterpart of
``cfgpp_tpu/weights/checkpoint.py``.

The JAX package writes Orbax trees, which the card's machine cannot read.
The port's native format is the HF layout that
`ModelBundle.from_pretrained` reads: one safetensors file per module
(``unet/``, ``vae/``, ``text_encoder/`` and, for sdxl, ``text_encoder_2/``;
each module's own dtypes; ``{"format": "pt"}`` metadata, which
transformers' loader asks of a safetensors file) and a ``BUNDLE`` file
holding the config name.
The JAX rules stay: a checkpoint of another config raises ``ValueError``,
and an sdxl checkpoint without its second text encoder raises
``FileNotFoundError`` (never random encoder-2 weights without an error).
"""

from __future__ import annotations

from pathlib import Path

from cfgpp_tpu_torch.weights.convert import load_bundle_dir_
from cfgpp_tpu_torch.weights.safetensors_io import save_file

# subdirectory -> (bundle attribute, file name), diffusers' and
# transformers' file names
MODULE_FILES = {
    "unet": ("unet", "diffusion_pytorch_model.safetensors"),
    "vae": ("vae", "diffusion_pytorch_model.safetensors"),
    "text_encoder": ("text_encoder", "model.safetensors"),
    "text_encoder_2": ("text_encoder_2", "model.safetensors"),
}


def save_bundle(bundle, path) -> int:
    """Write the bundle's modules and ``BUNDLE``; returns the bytes of the
    tensor files."""
    path = Path(path)
    total = 0
    for sub, (attr, name) in MODULE_FILES.items():
        module = getattr(bundle, attr)
        if module is None:
            continue
        (path / sub).mkdir(parents=True, exist_ok=True)
        total += save_file(module.state_dict(), path / sub / name,
                           metadata={"format": "pt"})
    (path / "BUNDLE").write_text(bundle.config.name)
    return total


def load_bundle(bundle, path):
    """Fill a structurally matching bundle (``ModelBundle._empty``,
    ``random_init``) from a checkpoint that `save_bundle` wrote."""
    path = Path(path)
    name = (path / "BUNDLE").read_text().strip()
    if name != bundle.config.name:
        raise ValueError(f"checkpoint is for {name!r}, bundle is "
                         f"{bundle.config.name!r}")
    if bundle.text_encoder_2 is not None and not (path / "text_encoder_2").is_dir():
        raise FileNotFoundError(f"checkpoint {path} has no text_encoder_2/ but "
                                f"the bundle ({name}) needs a second text "
                                "encoder")
    load_bundle_dir_(bundle, path)
    return bundle
