"""What decides ``correct``: images of the window, drawn from the seed once
it has closed, against the plain float32 reference's images of the same
prompts and seeds.

The program's image is the uint8 array it handed the host (a request) or the
PNG it wrote, read back from disk (a batch).  The reference is the
configuration's family's (``families/<family>``): it works out again
everything the program derived, from its weights, drawn again from the
seed, to the decoded image.  Each image's number is ``image_mae``, the mean
|program - reference| / 255 over its pixels, both uint8 (the reference
rounded as the program rounds); the run's is the worst over the images
checked, held to the cell's limit (``limits/<workload>.json``).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port import families, weights
from bench_port.reference.ops import Ops, no_tf32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def read_png(path: Path) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG -> [H, W, 3] uint8."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = head
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: depth {depth}, colour type {color}, "
                         f"interlace {interlace}; expected 8-bit RGB")
    stride = 3 * w
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, 3), axis=0).reshape(-1) % 256
        elif kind == 2:
            cur = (line + prior) % 256
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                left = cur[x - 3] if x >= 3 else 0
                up, ul = prior[x], (prior[x - 3] if x >= 3 else 0)
                if kind == 3:
                    pred = (left + up) // 2
                else:
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (
                        up if pb <= pc else ul)
                cur[x] = (line[x] + pred) % 256
        out[y] = prior = cur
    return out.astype(np.uint8).reshape(h, w, 3)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """[0, 1] -> uint8 by the program's rule, x * 255 + 0.5 truncated."""
    return (image.astype(np.float32) * 255.0 + 0.5).astype(np.uint8)


def compare(program_u8: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """The numbers of one image; ``reference`` in [0, 1], rounded to uint8
    as the program rounds, so that equal images read 0."""
    diff = np.abs(program_u8.astype(np.float64)
                  - to_uint8(reference).astype(np.float64)) / 255.0
    return {"image_mae": float(diff.mean())}


def pick(done: List, mix: Dict, seed: int) -> List[Tuple[object, int]]:
    """(finished unit, image within it) pairs drawn from the seed: of
    requests, ``check_images`` different ones; of batches, ``check_images``
    different slots of the batch (slot j holds the samples whose global
    index is j mod the batch), each from a finished batch drawn apart, so
    that a fault of one slot cannot hide."""
    if not done:
        return []
    rng = np.random.default_rng([seed % 2 ** 64, 2])
    b = len(done[0].unit.prompts)
    if b == 1:
        k = min(mix["check_images"], len(done))
        return [(done[i], 0) for i in sorted(rng.choice(len(done), k,
                                                        replace=False))]
    slots = sorted(rng.choice(b, min(mix["check_images"], b), replace=False))
    return [(done[int(rng.integers(len(done)))], int(j)) for j in slots]


def reference(config: Dict, seed: int, device, ops: Optional[Ops] = None,
              quant: Optional[str] = None):
    """The family's reference models with the program's weights drawn
    again from the seed, each in the dtype its module is served in (an int8
    cell's weights are quantized again from these, in the reference's
    layers)."""
    no_tf32()
    family = families.load(config)
    ref = family.reference(config, device, ops, quant)
    for name, module in ref.modules().items():
        weights.fill_(module, seed, name, DTYPES[config["dtypes"][name]],
                      family.MODULES, getattr(family, "DRAWS", None))
    return ref


def program_image(d, j: int) -> np.ndarray:
    return d.images[j] if d.images is not None else read_png(d.paths[j])


def check(config: Dict, mix: Dict, limits: Dict[str, float], seed: int,
          done: List, device) -> Tuple[bool, Dict[str, float]]:
    """(correct, worst numbers) over the images drawn from the window."""
    picks = pick(done, mix, seed)
    worst: Dict[str, float] = {}
    if picks:
        ref = reference(config, seed, device, quant=mix["quant"])
        for d, j in picks:
            index = None if d.unit.indices is None else d.unit.indices[j]
            r = ref.image(mix, mix["null_prompt"], d.unit.prompts[j],
                          d.unit.seed, index).cpu().numpy()
            for key, value in compare(program_image(d, j), r).items():
                worst[key] = max(worst.get(key, 0.0), value)
        del ref
    ok = bool(picks) and bool(limits) and all(
        worst[key] <= limit for key, limit in limits.items())
    return ok, worst
