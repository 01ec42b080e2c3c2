"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point, so it compiles in
seconds without PyTorch's headers (``int8_matmul.cu``, ``int8_conv.cu``
and ``flash_attention_int8.cu`` share the int8 primitives in
``csrc/int8_gemm.cuh``).  The shared library goes to
``build/cfgpp_tpu_torch/`` at the repository root (git-ignored), named by a
hash of the source, the headers and the flags: an unchanged source is built
once and then only loaded.  Nothing here runs at import time; the first CUDA call of a
kernel wrapper builds and loads its library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
# One shared library per source ``csrc/<name>.cu``.
LIBRARIES = ("flash_attention", "flash_attention_f32", "flash_attention_int8",
             "int8_conv", "int8_matmul")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cfgpp_tpu_torch"
# -fno-gnu-unique: a function-local static of a template (e.g. the shared
# memory allowance in csrc/int8_gemm.cuh's launch_pdl) is otherwise one
# object across every loaded library that instantiates the same template, so
# a second build of a source loaded in one process (tools/int8_ab.py) would
# skip its own kernels' set-up.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC,-fno-gnu-unique", "-Xptxas", "-v")

_libraries: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of cfgpp_tpu_torch "
                           "are built at first use and need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    parts = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_library(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    path = library_path(name)
    if path.exists():
        return BuildResult(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent build never loads half a file
    return BuildResult(path, seconds, proc.stdout + proc.stderr)


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; loaded once per process."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name).path))
        _libraries[name] = lib
    return lib
