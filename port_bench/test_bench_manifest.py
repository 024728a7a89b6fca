"""The manifest (``BENCHMARK.json``) against the benchmark's contract, and
the discovery of configurations, traffic mixes, metrics and limits by
name."""
from __future__ import annotations

import json
import re

import pytest

from port_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest()


def test_top_level_keys(m):
    assert set(m) == KEYS
    assert len(json.dumps(m)) <= 64 * 1024
    assert 1 <= m["run_seconds"] <= 51
    assert isinstance(m["run_seconds"], int)


def test_command_and_paths(m):
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
        assert (manifest.ROOT / p).is_dir()
    assert 1 <= len(m["command"]) <= 32
    for word in m["command"]:
        assert LINE.match(word) and not word.startswith("/")


def test_names_and_units(m):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for group in ("configs", "workloads"):
        got = [e["name"] for e in m[group]]
        assert len(got) == len(set(got))
    metrics = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES


def test_entries_have_just_their_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(p["layer"])


def _reports(m, cell, metric_name):
    metric = next(e for e in m["end_to_end"] if e["name"] == metric_name)
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_enough(m):
    for w in m["workloads"]:
        cell = manifest.cell(w["name"], m)
        e2e = [e["name"] for e in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_moves_names_a_metric_each_listed_cell_reports(m):
    e2e = {e["name"] for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for p in m["per_layer"]:
        assert p["moves"] in e2e
        for cell in p.get("workloads", sorted(cells)):
            assert cell in cells
            assert _reports(m, cell, p["moves"]), (p["name"], cell)


def test_one_layer_name_per_layer(m):
    layers = {p["layer"] for p in m["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


def test_every_configuration_has_a_cell(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))


def test_discovery_by_name(m):
    for w in m["workloads"]:
        cell = manifest.cell(w["name"], m)
        assert cell.config["name"] == w["config"]
        manifest.module("estimators", cell.config["estimator"])
        manifest.module("drivers", cell.traffic["kind"])
        assert (manifest.PKG / "limits" / f"{w['name']}.json").exists()
    for p in m["per_layer"]:
        assert callable(manifest.metric_reader(p["name"]))


def test_configuration_files_lie_under_paths(m):
    for c in m["configs"]:
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        cfg = manifest.read_json(manifest.ROOT / c["file"])
        assert cfg["name"] == c["name"]


def test_a_missing_cell_is_refused(m):
    with pytest.raises(KeyError):
        manifest.cell("no_such_cell", m)


def test_limits_lie_between_their_readings(m):
    for w in m["workloads"]:
        limits = manifest.cell(w["name"], m).limits
        assert limits
        for name, entry in limits.items():
            if name.startswith("_"):
                continue                    # a note on the readings
            if entry.get("exact"):
                assert entry["limit"] == 0, name
                continue
            assert entry["lower"] < entry["limit"] < entry["upper"], name
