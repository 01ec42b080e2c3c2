"""Cells at test sizes: the port's tiny presets (``tiny_sd``, ``tiny_sdxl``)
as benchmark configurations, under a cell's mix at 64^2."""

from __future__ import annotations

import dataclasses
from typing import Dict

from bench_port.manifest import benchmark
from bench_port.manifest import cell as load_cell

# A cell whose files the benchmark keeps though BENCHMARK.json leaves it out
# (its batch-1 time follows the host's speed too closely for a bound: PERF.md,
# Open questions); its mix and reference are still tested here.
KEPT = {"configs": [{"name": "sd15", "file": "bench_port/configs/sd15.json"}],
        "workloads": [{"name": "sd15_t2i_b1", "config": "sd15",
                       "traffic": "t2i_b1_ddim50", "chips": 1}]}


def with_kept_cells() -> Dict:
    bm = benchmark()
    for key, entries in KEPT.items():
        names = {e["name"] for e in bm[key]}
        bm[key] += [e for e in entries if e["name"] not in names]
    return bm


def tiny_config(preset: str, dtype: str = "float32") -> Dict:
    from cfgpp_tpu_torch.configs import get_bundle_config
    c = get_bundle_config(preset)
    d = {"name": preset, "preset": preset, "dtype": dtype,
         "dtypes": {"unet": dtype, "vae": "float32",
                    "vae_decode_compute": dtype, "text_encoder": "float32",
                    "text_encoder_2": "float32"},
         "tf32": {"cudnn": False, "cuda_matmul": False}}
    for part in ("unet", "vae", "text_encoder", "text_encoder_2"):
        v = getattr(c, part)
        if v is not None:
            d[part] = {k: list(x) if isinstance(x, tuple) else x
                       for k, x in dataclasses.asdict(v).items()}
    return d


def tiny_cell(workload: str, dtype: str = "float32", **mix) -> Dict:
    """The cell ``workload`` with its configuration's tiny preset, its mix at
    64^2 (and ``mix``'s overrides), its limits and metrics."""
    cell = load_cell(workload, with_kept_cells())
    preset = {"sd15": "tiny_sd", "sdxl": "tiny_sdxl"}[cell["config"]["name"]]
    cell["config"] = tiny_config(preset, dtype)
    cell["mix"] = {**cell["mix"], "resolution": 64, **mix}
    return cell
