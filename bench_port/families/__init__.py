"""A configuration's model family: what the harness needs to know of a
model's architecture, found by the name the configuration file gives
(``"family"``; a file without the key is ``sd_unet``, the SD / SDXL UNet
family) and loaded by path from ``families/<name>.py`` or
``families/<name>/__init__.py``, so that a new family is new files only and
the harness imports none by name.

A family provides:

* ``MODULES``: {module name: weight tag}.  Each module is filled from the
  seed under its tag (`bench_port.weights.fill_`), in the dtype that the
  configuration's ``"dtypes"`` gives under its name; the program's module
  and the reference's of one name hold the same values.
* ``DRAWS`` (optional): the draws of parameters outside the module types
  that `bench_port.weights` knows, by parameter name or module type.
* ``check_config(config)``: raises where the port's preset differs from the
  configuration file.
* ``build(config, mix, seed, device)``: the port's engine with its modules
  filled from the seed (and quantized as the mix says), whose
  ``sample([null, prompt], cfg_guidance=, seed=, resolution=)`` or
  ``sample_batch(...)`` the mix's ``entry`` calls.
* ``with_nfe(engine, mix, nfe)``: an engine over the same modules that
  takes ``nfe`` steps (the warm-up's).
* ``spans(program)``: the (object, attribute, span name) triples whose
  calls the harness wraps in spans when tracing is on (``program.engine``
  is the engine that `build` made).
* ``reference(config, device, ops, quant)``: the plain reference, an object
  with ``modules()`` ({name: module}, unfilled) and ``image(mix,
  null_prompt, prompt, seed, index)`` (float32 [H, W, 3] in [0, 1]),
  whose products go through ``bench_port/reference/ops.py:Ops``;
  ``set_ops(module, ops)`` sets them; ``compute_dtypes(config)``: {module
  name: the dtype it computes in}, which the control lowers.
* ``unit_flops(config, mix)`` and ``attention_sites(config, mix)``: the
  FLOPs of one unit of the mix and its attention shapes
  (`bench_port/flops.py`).
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
DEFAULT = "sd_unet"
ROOTS = (HERE,)             # where family files are looked for, in order
NAME = re.compile(r"^[A-Za-z0-9_]{1,64}$")


def load(config: Dict):
    """The family module that ``config`` names."""
    name = config.get("family", DEFAULT)
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{config.get('name')}: family {name!r} is not a "
                         "name of letters, digits and _")
    tried = []
    for root in ROOTS:
        for path, package in ((root / f"{name}.py", None),
                              (root / name / "__init__.py", root / name)):
            tried.append(path)
            if path.is_file():
                return _module(f"bench_port.families.{name}", path, package)
    raise FileNotFoundError(
        f"{config.get('name')}: family {name!r} has no file: "
        + ", ".join(str(p) for p in tried))


def _module(qualname: str, path: Path, package):
    loaded = sys.modules.get(qualname)
    if loaded is not None and Path(loaded.__file__).resolve() == path:
        return loaded
    spec = importlib.util.spec_from_file_location(
        qualname, path, submodule_search_locations=(
            None if package is None else [str(package)]))
    module = importlib.util.module_from_spec(spec)
    sys.modules[qualname] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[qualname]
        raise
    return module
