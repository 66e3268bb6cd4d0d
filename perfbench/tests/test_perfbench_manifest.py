"""BENCHMARK.json against the benchmark's files and the contract's limits
on names, units and keys; the registry finds new files with no edit."""

import json
import re
import shutil
import types

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_keys_names_and_units(man):
    assert set(man) == TOP_KEYS
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_and_config_has_its_files(man):
    configs = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        cell = harness.load_json("cells", w["name"])
        assert cell["config"] == w["config"] in configs
        assert cell["why"] == w["why"]
        assert (harness.ROOT / "drivers" / f"{cell['driver']}.py").is_file()
    for c in configs:
        assert harness.load_json("configs", c)["name"] == c
    for m in man["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_each_cell_reports_setup_another_e2e_and_a_layer_metric(man):
    for w in man["workloads"]:
        e2e, layer = harness.cell_metrics(man, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:  # a layer metric moves an end-to-end metric the cell reports
            assert m["moves"] in names


def test_a_new_cell_config_driver_and_metric_are_found_with_no_edit(tmp_path, monkeypatch, man):
    root = tmp_path / "perfbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    config = dict(harness.load_json("configs", "ssd300_voc"), name="ssd300_new")
    (root / "configs" / "ssd300_new.json").write_text(json.dumps(config))
    (root / "cells" / "ssd300_new.probe.json").write_text(json.dumps(
        dict(config="ssd300_new", driver="probe", why="a probe")))
    (root / "drivers" / "probe.py").write_text(
        "def run(run):\n    run.e2e['probe_per_s'] = 3.0\n    run.values['x'] = 2.0\n")
    (root / "metrics" / "probe.x.py").write_text("def read(run):\n    return run.values['x']\n")
    man = dict(man)
    man["workloads"] = man["workloads"] + [dict(name="ssd300_new.probe", config="ssd300_new",
                                                traffic="probe", chips=1, why="a probe")]
    man["end_to_end"] = man["end_to_end"] + [dict(
        name="probe_per_s", unit="1/s", better="higher", bound=0.05, source="host_clock",
        workloads=["ssd300_new.probe"])]
    man["per_layer"] = man["per_layer"] + [dict(
        name="probe.x", unit="count", better="lower", source="host_clock", layer="device",
        moves="probe_per_s", workloads=["ssd300_new.probe"])]
    monkeypatch.setattr(harness, "ROOT", root)
    cell = harness.load_json("cells", "ssd300_new.probe")
    run = harness.Run(types.SimpleNamespace(seed=1, seconds=1, trace=0, device="cpu"),
                      "ssd300_new.probe", cell, harness.load_json("configs", cell["config"]), 0.0)
    harness.load_module("drivers", cell["driver"]).run(run)
    e2e, layer = harness.cell_metrics(man, "ssd300_new.probe")
    assert {m["name"] for m in e2e} == {"probe_per_s", "setup_s"}
    assert [m["name"] for m in layer] == ["probe.x"]
    assert harness.load_module("metrics", "probe.x").read(run) == 2.0
    assert run.e2e["probe_per_s"] == 3.0


def test_run_seconds_fits_the_check_with_24_cells(man):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= man["run_seconds"] <= 51 and total <= 43200
