"""The benchmark's files: BENCHMARK.json within its contract, and every cell,
configuration, traffic kind and per-layer reader found by name."""

import json
import os
import re

import pytest

from tdrbench.harness import common

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL_NAMES = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "tdrbench/run.py"]
    assert BENCH["paths"] == ["tdrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24                                   # the most cells the file may hold
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert len(set(CELL_NAMES)) == len(CELL_NAMES)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert one_line(w["why"]) and w["chips"] in (1, 4)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELL_NAMES:
        reported = [m["name"] for m in common.metrics_of(BENCH, "end_to_end",
                                                         cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert common.metrics_of(BENCH, "per_layer", cell)


def test_per_layer_metrics_name_a_moved_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            moved = [e["name"] for e in common.metrics_of(BENCH, "end_to_end",
                                                          cell)]
            assert m["moves"] in moved
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_cell_files_resolve_by_name(cell):
    import tdrbench.run as run

    bench, entry, config, params = run.cell_files(cell)
    assert entry["name"] == cell
    kind = common.load_module("traffic", params["kind"])
    assert hasattr(kind, "Run")
    assert params["limits"]
    for m in common.metrics_of(bench, "per_layer", cell):
        assert callable(common.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = os.path.join(common.ROOT, cfg["file"])
    assert cfg["file"].startswith("tdrbench/")
    with open(path) as f:
        data = json.load(f)
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert all(k in data for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(cfg["file"]) == 1


def test_every_reader_file_has_a_metric():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(common.BENCH_DIR,
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == names


def test_no_file_names_outside_the_name_characters():
    for dirpath, _, files in os.walk(common.BENCH_DIR):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), common.ROOT)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
