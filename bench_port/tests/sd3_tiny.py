"""The SD3 family at test sizes: the port's ``tiny_sd3`` preset as a
benchmark configuration, under the ``sd35_large_b1`` cell's mix at 16^2 and
4 steps (two MMDiT blocks, the last ``context_pre_only``; 16 T5 tokens).

The cell's limit is set from the card's runs at published widths, where 38
blocks and 28 steps carry bfloat16's rounding further than two blocks and
4 steps do; the tiny cell has its own, set the same way from its own
readings (CPU, seed 2^31 + 3131): the bfloat16 program 0.0024, the fp8
control 0.021-0.025 on its two images, so 0.008 lies 3.3x above the one
and 2.6x below the other.  Against it the faults of
``test_bench_port_sd3.py`` read 0.012 (the decode's shift left out) to
0.20 (a step that returns its state)."""

from __future__ import annotations

import dataclasses
from typing import Dict

from bench_port import manifest
from bench_port.families.sd3_mmdit import PARTS

TINY_IMAGE_MAE = 0.008

CELL = "sd35_large_b1"


def sd35_cell() -> Dict:
    """``sd35_large_b1`` at published widths."""
    return manifest.cell(CELL)


def tiny_sd3_config(dtype: str = "float32") -> Dict:
    from cfgpp_tpu_torch.configs_sd3 import get_sd3_config
    c = dataclasses.asdict(get_sd3_config("tiny_sd3"))
    config = {"name": "tiny_sd3", "family": "sd3_mmdit", "preset": "tiny_sd3",
              "dtypes": {"transformer": dtype, "text_encoder_3": dtype,
                         "text_encoder": "float32",
                         "text_encoder_2": "float32", "vae": "float32",
                         "vae_decode_compute": dtype},
              "tf32": {"cudnn": False, "cuda_matmul": False},
              "max_sequence_length": c["max_sequence_length"]}
    for part in PARTS:
        config[part] = {k: list(v) if isinstance(v, tuple) else v
                        for k, v in c[part].items()}
    return config


def tiny_sd3_cell(dtype: str = "float32", **mix) -> Dict:
    """``sd35_large_b1`` with the tiny configuration, its mix at 16^2 and
    4 steps (and ``mix``'s overrides), the tiny limit and the cell's
    metrics."""
    cell = sd35_cell()
    cell["config"] = tiny_sd3_config(dtype)
    cell["limits"] = {"image_mae": TINY_IMAGE_MAE}
    cell["mix"] = {**cell["mix"], "resolution": 16, "nfe": 4, **mix}
    return cell
