"""The port's safetensors reader and writer against the `safetensors`
package, in both directions.

``cfgpp_tpu_torch/weights/safetensors_io.py`` reads and writes the format
without the package (the card's machine has none).  Tensors of all six
dtypes (F32, F16, BF16, I8, I32, I64), made from a seed with numpy, with
``__metadata__``, 0-d and empty tensors among them: files written by
``safetensors.numpy.save_file`` and ``safetensors.torch.save_file`` must
read back bit for bit through the port, and files the port writes must
read back bit for bit through the package.  Damaged files (truncated,
overlapping offsets, an unknown dtype) and a non-contiguous view raise, the
file named in the message.

Tolerance: none (bit for bit, dtype and shape equal).
"""

import json
import struct

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from cfgpp_tpu_torch.weights import safetensors_io as io

META = {"format": "pt", "note": "seeded"}


def tensors():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32) * 100
    out = {
        "f32": torch.from_numpy(f32),
        "f16": torch.from_numpy(rng.standard_normal((4, 2, 3)).astype(
            np.float16)),
        "bf16": torch.from_numpy(f32).bfloat16(),
        "i8": torch.from_numpy(rng.integers(-128, 128, (7,), dtype=np.int8)),
        "i32": torch.from_numpy(rng.integers(-2**31, 2**31, (2, 3),
                                             dtype=np.int32)),
        "i64": torch.arange(77, dtype=torch.int64)[None],   # position_ids
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }
    return out


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("writer", ["safetensors.torch", "safetensors.numpy"])
def test_package_files_read_bit_for_bit(tmp_path, writer):
    want = tensors()
    path = tmp_path / "x.safetensors"
    if writer == "safetensors.torch":
        safetensors.torch.save_file(want, str(path), metadata=META)
    else:                       # numpy has no bfloat16
        want.pop("bf16")
        safetensors.numpy.save_file({k: v.numpy() for k, v in want.items()},
                                    str(path), metadata=META)
    assert io.read_header(path)[1] == META
    assert_same(io.load_file(path), want)


def test_port_files_read_bit_for_bit_by_the_package(tmp_path):
    want = tensors()
    path = tmp_path / "x.safetensors"
    nbytes = io.save_file(want, path, metadata=META)
    assert nbytes == path.stat().st_size
    assert_same(safetensors.torch.load_file(str(path)), want)
    with safetensors.safe_open(str(path), "pt") as f:
        assert f.metadata() == META
    want.pop("bf16")            # numpy reads it as ml_dtypes' bfloat16
    got = safetensors.numpy.load_file(str(path))
    got.pop("bf16")
    assert_same({k: torch.from_numpy(v) for k, v in got.items()}, want)
    # and the port reads its own file back
    assert_same(io.load_file(path), tensors())


def test_non_contiguous_view_is_refused(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    with pytest.raises(ValueError, match="not contiguous"):
        io.save_file({"w": w.t()}, tmp_path / "x.safetensors")
    io.save_file({"w": w.t().contiguous()}, tmp_path / "x.safetensors")
    assert torch.equal(io.load_file(tmp_path / "x.safetensors")["w"], w.t())


def _write_raw(path, header, data: bytes):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("damage", ["truncated data", "truncated header",
                                    "overlap", "unknown dtype",
                                    "offsets disagree with the shape"])
def test_damaged_files_raise_with_the_file_name(tmp_path, damage):
    path = tmp_path / f"{damage.replace(' ', '_')}.safetensors"
    if damage.startswith("truncated"):
        io.save_file(tensors(), path)
        raw = path.read_bytes()
        path.write_bytes(raw[:-10] if damage == "truncated data" else raw[:20])
    else:
        entries = {
            "overlap": {"a": {"dtype": "F32", "shape": [2],
                              "data_offsets": [0, 8]},
                        "b": {"dtype": "F32", "shape": [2],
                              "data_offsets": [4, 12]}},
            "unknown dtype": {"a": {"dtype": "F8_E4M3", "shape": [16],
                                    "data_offsets": [0, 16]}},
            "offsets disagree with the shape": {
                "a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
        }[damage]
        _write_raw(path, entries, bytes(16))
    with pytest.raises(ValueError, match=str(path.name)):
        io.load_file(path)
