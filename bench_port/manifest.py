"""Finds what belongs to a cell by the names in ``BENCHMARK.json``: the
configuration's file, the mix ``mixes/<traffic>.json``, the limits of
`correct` ``limits/<workload>.json`` and each per-layer metric's reader
``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def benchmark() -> Dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _one(entries: List[Dict], name: str, what: str) -> Dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in "
                       "BENCHMARK.json")
    return found[0]


def cell(name: str, bm: Dict = None) -> Dict:
    """The workload entry, with its configuration and mix loaded:
    {"workload", "config", "mix", "limits", "end_to_end", "per_layer"}."""
    bm = bm or benchmark()
    w = _one(bm["workloads"], name, "workload")
    cfg_entry = _one(bm["configs"], w["config"], "configuration")
    config = json.loads((REPO / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() \
        else {}

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {"workload": w, "config": config, "mix": mix, "limits": limits,
            "end_to_end": [m for m in bm["end_to_end"] if applies(m)],
            "per_layer": [m for m in bm["per_layer"] if applies(m)]}


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
