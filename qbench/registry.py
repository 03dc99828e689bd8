"""Finds every piece of a cell by its name in BENCHMARK.json.

A configuration is the file its `configs` entry names, and its model
family qbench/families/<model_type>.py, by the file's `model_type`; a
traffic mix is qbench/traffic/<traffic>.json; a cell's output limits are
qbench/limits/<cell>.json; an end-to-end metric is qbench/e2e/<name>.py and
a per-layer metric qbench/metrics/<name>.py. Adding a cell, a
configuration, a model family, a mix or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import List

QBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(QBENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT):
    """qbench/<kind>/<name>.py, loaded by path (names may hold dots)."""
    path = os.path.join(root, "qbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"qbench.{kind}.{name.replace('.', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_of(cfg: dict, root: str = ROOT):
    """The model family of a configuration (qbench/families/__init__.py)."""
    return load_module("families", cfg["model_type"], root)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    family: object  # the configuration's model family module
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    root: str  # the checkout its files were found in


def load_config(name: str, root: str = ROOT) -> dict:
    """A configuration by its name in BENCHMARK.json's `configs`."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    conf = {c["name"]: c for c in bench["configs"]}[name]
    return load_json(os.path.join(root, conf["file"]))


def load_traffic(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "qbench", "traffic", name + ".json"))


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") in reported if "moves" in entry else True


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    config = load_config(w["config"], root)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(
        name=name,
        config_name=w["config"],
        config=config,
        family=family_of(config, root),
        traffic_name=w["traffic"],
        traffic=load_traffic(w["traffic"], root),
        chips=int(w["chips"]),
        limits=load_json(os.path.join(root, "qbench", "limits", name + ".json")),
        end_to_end=e2e,
        per_layer=per_layer,
        root=root,
    )
