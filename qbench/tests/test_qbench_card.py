"""On the card, at each cell's own size. Skips without a CUDA device; run on
the H100 with `python3 -m pytest qbench/tests -m card -s` from the root of
a checkout.

* On three seeds a cell, qbench/check.py's own judgment holds the program's
  readings correct and the control's (the reference at int4 activations,
  its first choice at each judged position) not correct.
* In each decode-batch cell, a run whose decode steps' logits are zeroed
  from row B // 2 on (128 rows) comes out not correct.
"""

import json
import time

import pytest
import torch

from qbench import registry
from qbench import run as qrun
from qbench.tests.conftest import drop_half_the_batch

CELLS = [w["name"] for w in registry.load_json(f"{registry.ROOT}/BENCHMARK.json")["workloads"]]
SEEDS = (101, 102, 103)
SECONDS = 10.0


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    from qbench import calibrate

    for name in CELLS:
        cell = registry.load_cell(name)
        for seed in SEEDS:
            got = {}

            def checker(cell, seed, requests, device):
                got.update(calibrate.readings(cell, seed, requests, device))
                return True, {}

            qrun.run_cell(cell, seed, SECONDS, False, card, time.perf_counter(), checker=checker)
            print(name, seed, json.dumps(got), flush=True)
            assert got["program_correct"] and not got["control_correct"], (name, got)
            torch.cuda.empty_cache()


@pytest.mark.card
def test_half_the_batch_dropped_fails_at_the_cells_size(card, monkeypatch):
    drop_half_the_batch(monkeypatch)
    for name in CELLS:
        cell = registry.load_cell(name)
        if cell.traffic_name != "decode-batch":
            continue
        out = qrun.run_cell(cell, 104, SECONDS, False, card, time.perf_counter())
        print(name, json.dumps(out["checks"]), flush=True)
        assert not out["correct"], (name, out["checks"])
        torch.cuda.empty_cache()
