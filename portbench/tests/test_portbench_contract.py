"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a mix and a metric added as files, by name."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        harness.load("metrics", m["name"])
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for name in names:
        assert NAME.match(name), name
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items() if n != "setup_s")
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_budget_fits_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_added_files_are_found_by_name(tmp_path, monkeypatch):
    """A new configuration, mix and metric, added as files to a copy of this
    folder, are found by the names a new BENCHMARK.json entry gives."""
    copy = tmp_path / "portbench"
    shutil.copytree(harness.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "metrics" / "solves_done.py").write_text(
        "def read(run):\n    return float(len(run.outcomes))\n")
    (copy / "traffic" / "burst.json").write_text(
        json.dumps({"start": "random", "variants": 1}))
    cfg = json.loads((copy / "configs" / "dense10240.json").read_text())
    cfg["n"] = 2048
    (copy / "configs" / "dense2048.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(harness, "HERE", str(copy))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    bench = {"configs": [{"name": "dense2048", "file": "portbench/configs/dense2048.json"}],
             "end_to_end": [{"name": "solves_done", "unit": "solves"}], "per_layer": []}
    cell = {"name": "dense2048.burst", "config": "dense2048", "traffic": "burst"}
    config, mix = harness.cell_files(bench, cell)
    assert config["n"] == 2048 and mix["start"] == "random"
    assert harness.cell_metrics(bench, cell, False) == bench["end_to_end"]
    run = harness.Run(cell, config, mix)
    run.outcomes = [{}] * 3
    assert harness.load("metrics", "solves_done").read(run) == 3.0
    # the same quantity split by the end-to-end metric its cells move
    assert harness.load("metrics", "solves_done.burst") is harness.load("metrics",
                                                                         "solves_done")
    with pytest.raises(FileNotFoundError):
        harness.load("metrics", "no_such_metric.burst")
