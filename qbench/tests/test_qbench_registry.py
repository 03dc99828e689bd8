"""Every piece of every cell is found by name, and a new configuration,
traffic mix or metric is picked up from new files and entries alone,
without an edit to any file already there. BENCHMARK.json keeps to the
contract's shape."""

import hashlib
import json
import os
import re
import shutil

import pytest

from qbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.load_json(os.path.join(registry.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"])) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("qbench/") and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_is_found(cell):
    c = registry.load_cell(cell)
    assert c.config["serving"] and c.traffic["loop"] in ("closed", "open")
    assert c.limits and all(float(v["limit"]) > 0 for v in c.limits.values())
    from qbench.check import READINGS

    assert set(c.limits) <= set(READINGS)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.end_to_end:
        mod = registry.load_module("e2e", m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    for m in c.per_layer:
        mod = registry.load_module("metrics", m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        assert m["moves"] in reported


def _digest(root):
    h = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                h[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return h


def test_new_files_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.QBENCH, root / "qbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "qbench")
    q = root / "qbench"
    cfg = json.load(open(q / "configs" / "mistral-7b-v0.1.w4a8kv4.json"))
    cfg["serving"]["group_size"] = 128
    json.dump(cfg, open(q / "configs" / "mistral-7b-v0.1.w4a8kv4-g128.json", "w"))
    tr = json.load(open(q / "traffic" / "chat-bursty.json"))
    tr["arrival"]["cv"] = 1.0
    json.dump(tr, open(q / "traffic" / "chat-steady.json", "w"))
    json.dump({"mean_gap": {"limit": 1.0}}, open(q / "limits" / "mistral-g128.chat-steady.json", "w"))
    (q / "metrics" / "queue_wait_ms.chat.py").write_text(
        'LAYER = "scheduler"\nUNIT = "ms"\nSOURCE = "host_clock"\nMOVES = "ttft_p95_ms"\n'
        "def read(run):\n    return 1.0\n")
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "mistral-7b-v0.1.w4a8kv4-g128", "source": "x",
                             "file": "qbench/configs/mistral-7b-v0.1.w4a8kv4-g128.json",
                             "reduced": [], "why": "K8"})
    bench["workloads"].append({"name": "mistral-g128.chat-steady",
                               "config": "mistral-7b-v0.1.w4a8kv4-g128",
                               "traffic": "chat-steady", "chips": 1, "why": "control"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("mistral-g128.chat-steady")
    bench["per_layer"].append({"name": "queue_wait_ms.chat", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "scheduler",
                               "moves": "ttft_p95_ms", "workloads": ["mistral-g128.chat-steady"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    after = _digest(root / "qbench")
    assert all(after[k] == v for k, v in before.items())  # nothing already there changed
    c = registry.load_cell("mistral-g128.chat-steady", root=str(root))
    assert c.config["serving"]["group_size"] == 128 and c.traffic["arrival"]["cv"] == 1.0
    assert "queue_wait_ms.chat" in [m["name"] for m in c.per_layer]
    assert registry.load_module("metrics", "queue_wait_ms.chat", root=str(root)).read(None) == 1.0
