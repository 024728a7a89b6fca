"""Finds everything a cell needs by its name, in files of their own.

``BENCHMARK.json`` at the checkout's root names the cells; a cell names
a configuration (``configs/<config>.json``, whose ``estimator`` names a
module ``estimators/<estimator>.py``) and a traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names a module
``drivers/<kind>.py``). Each per-layer metric is ``metrics/<name>.py``
with a function ``read(run)``, and each cell's correctness limits are
``limits/<cell>.json``. Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from dataclasses import dataclass, field

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest(path: pathlib.Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and
    the metrics it reports."""
    manifest = manifest if manifest is not None else load_manifest()
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = read_json(ROOT / configs[entry["config"]]["file"])
    traffic = read_json(PKG / "traffic" / f"{entry['traffic']}.json")
    limits_path = PKG / "limits" / f"{name}.json"
    limits = read_json(limits_path) if limits_path.exists() else {}
    return Cell(
        name=name, entry=entry, config=config, traffic=traffic,
        limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def module(kind: str, name: str):
    """``port_bench.<kind>.<name>``: an estimator or a driver."""
    return importlib.import_module(f"port_bench.{kind}.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py`` (a name may hold
    dots, so the file is loaded by its path)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
