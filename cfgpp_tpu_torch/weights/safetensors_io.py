"""Reader and writer of the safetensors format, without the `safetensors`
package (the card's machine has none).

Layout: an unsigned 64-bit little-endian header length N, then N bytes of
JSON ``{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin,
end]}, ...}`` with an optional ``"__metadata__": {str: str}``, then the raw
little-endian tensor bytes; offsets count from the end of the header.

Dtypes: F32, F16, BF16, I8, I32 and I64 (CLIP checkpoints carry int64
``position_ids``).  The reader maps the data with ``numpy.memmap`` and
copies each tensor out of it once; numpy has no bfloat16, so BF16 is read as
int16 and viewed as ``torch.bfloat16``.  The writer takes contiguous tensors
only: the bytes of a non-contiguous view are not the tensor it shows.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

PathLike = Union[str, Path]

# name in the header -> (numpy dtype of the bytes, torch dtype of the tensor)
DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "I8": (np.dtype("i1"), torch.int8),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}
_NAMES = {torch_dt: name for name, (_, torch_dt) in DTYPES.items()}
# the header may not claim more than this (the safetensors package's limit)
MAX_HEADER = 100_000_000


def read_header(path: PathLike) -> Tuple[Dict[str, dict], Dict[str, str], int]:
    """(tensor entries, ``__metadata__``, byte offset of the data) of a
    safetensors file, each entry checked against the file: a known dtype,
    offsets within the data and as long as the shape needs, no two
    tensors sharing bytes."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated safetensors file ({size} "
                             "bytes, no header length)")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: truncated safetensors file (header of"
                             f" {n} bytes, file of {size})")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the safetensors header is no JSON: "
                             f"{e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is no JSON object")
    meta = header.pop("__metadata__", None) or {}
    start, data_len = 8 + n, size - 8 - n
    spans = []
    for name, entry in header.items():
        dtype = entry.get("dtype")
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}; "
                             f"this reader knows {sorted(DTYPES)}")
        begin, end = entry["data_offsets"]
        need = math.prod(entry["shape"]) * DTYPES[dtype][0].itemsize
        if not 0 <= begin <= end or end - begin != need:
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"[{begin}, {end}] for {need} bytes of "
                             f"{dtype}{entry['shape']}")
        if end > data_len:
            raise ValueError(f"{path}: truncated safetensors file (tensor "
                             f"{name!r} ends at byte {end} of the data, the "
                             f"file holds {data_len})")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end, a), (begin, _, b) in zip(spans, spans[1:]):
        if begin < end:
            raise ValueError(f"{path}: tensors {a!r} and {b!r} overlap")
    return header, meta, start


def load_file(path: PathLike) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU (name -> tensor; the
    ``__metadata__`` is `read_header`'s)."""
    header, _, start = read_header(path)
    out: Dict[str, torch.Tensor] = {}
    if not header:
        return out
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=start) \
        if Path(path).stat().st_size > start else np.empty(0, np.uint8)
    for name, entry in header.items():
        np_dt, torch_dt = DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        t = torch.from_numpy(np.array(data[begin:end]).view(np_dt).reshape(
            entry["shape"]))
        out[name] = t.view(torch.bfloat16) if torch_dt == torch.bfloat16 else t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: PathLike,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (contiguous, of the dtypes in ``DTYPES``, on any
    device) as one safetensors file, data in name order; returns the bytes
    written."""
    path = Path(path)
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {t.dtype}; "
                             f"this writer knows {sorted(DTYPES)}")
        if not t.is_contiguous():
            raise ValueError(f"{path}: tensor {name!r} is not contiguous: "
                             "write .contiguous() of it")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().to("cpu").reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(raw) + offset
