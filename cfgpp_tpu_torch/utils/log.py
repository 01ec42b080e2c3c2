"""Logging, workdir and seeding helpers, counterpart of
``cfgpp_tpu/utils/log.py`` (the reference's ``utils/log_util.py``).

``make_gif`` is not ported: no entry point calls it, and the card's
machine has no PIL to stitch frames with.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def get_logger(name: str = "cfgpp_tpu_torch", level: int = logging.INFO,
               logfile: Optional[str] = None) -> logging.Logger:
    """A logger to stdout (and ``logfile``); the level and the file are
    applied on every call, so a later, more specific call takes effect."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.setLevel(level)
    if logfile and not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == str(Path(logfile).absolute())
            for h in logger.handlers):
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def create_workdir(workdir) -> Path:
    """Make <workdir>/result (log_util.py:44-45)."""
    p = Path(workdir)
    p.joinpath("result").mkdir(parents=True, exist_ok=True)
    return p


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy (host-side shuffling) and return a CPU torch.Generator
    seeded with ``seed``.  The engine takes an explicit seed for each
    request and seeds its own generators on the device, so no global
    torch RNG is seeded here."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def save_floats(values: Sequence[float], path) -> None:
    """One float a line."""
    with open(path, "w") as f:
        for v in values:
            f.write(f"{float(v)}\n")
