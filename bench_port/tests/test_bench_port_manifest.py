"""BENCHMARK.json against the benchmark's contract: names, units, keys and
limits, every file found by name, every metric reported where it moves an
end-to-end metric, and the configurations equal to the port's presets."""

import json
import re

import pytest

from bench_port import manifest

BM = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BM["workloads"]]
METRICS = BM["end_to_end"] + BM["per_layer"]


def test_top_level_keys_and_size():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert len((manifest.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BM["command"]) <= 32
    assert all(TEXT.match(w) for w in BM["command"])
    assert BM["paths"] == ["bench_port"]
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51


def test_check_fits_the_time_limit_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BM["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_legal_and_unique(kind):
    names = [e["name"] for e in BM[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entry_keys():
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert TEXT.match(m["layer"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_pairs_are_unique_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in BM["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in BM["workloads"]} == \
        {c["name"] for c in BM["configs"]}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(workload):
    cell = manifest.cell(workload)
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BM["per_layer"]])
def test_each_layer_metric_cell_reports_what_it_moves(metric):
    m = next(m for m in BM["per_layer"] if m["name"] == metric)
    moved = next(e for e in BM["end_to_end"] if e["name"] == m["moves"])
    assert "workloads" in m
    assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_layer_names_are_shared_letter_for_letter():
    layers = {m["layer"] for m in BM["per_layer"]}
    assert len({layer.lower() for layer in layers}) == len(layers)


@pytest.mark.parametrize("workload", CELLS)
def test_config_mix_and_limits_found_by_name(workload):
    cell = manifest.cell(workload)
    w = cell["workload"]
    assert cell["config"]["name"] == w["config"]
    assert cell["mix"]["name"] == w["traffic"]
    assert cell["limits"], f"no limits/{workload}.json"
    for name, limit in cell["limits"].items():
        assert name == "image_mae"
        assert limit > 0


@pytest.mark.parametrize("metric", [m["name"] for m in BM["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(manifest.reader(metric))


def test_files_are_named_from_name_characters():
    for path in manifest.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(manifest.REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


@pytest.mark.parametrize("config", [c["name"] for c in BM["configs"]])
def test_config_file_is_the_port_preset(config):
    from bench_port import families
    entry = next(c for c in BM["configs"] if c["name"] == config)
    data = json.loads((manifest.REPO / entry["file"]).read_text())
    assert data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] == []
    families.load(data).check_config(data)
