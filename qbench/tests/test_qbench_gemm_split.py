"""gemm_split_pct.batch (qbench/metrics/): the share of the W4A8
per-channel GEMM launches that split K, read from the program's counter
samples `gemm_split_launches` over `gemm_launches` inside the traced steps,
on synthetic samples; and its entry in BENCHMARK.json."""

import json
import os
import types

import pytest

from qbench import counters, registry
from qbench.harness import Step
from qserve_tpu_torch.utils.tracing import Sample

NAME = "gemm_split_pct.batch"
CELLS = ["mistral-7b.decode-batch", "mixtral-8x7b.decode-batch", "mixtral-8x7b.doc-batch",
         "mellum2-12b.code-repo"]


def _step(t0, t1):
    return Step(t0, t1, "decode", 0, [], [], 0, 0, 0)


def _sample(name, t, value=1):
    ns = int(t * 1e9)
    return Sample(name, 0, ns, ns, value)


# two traced steps, [1, 2] s and [3, 4] s on the harness's clock
RUN = types.SimpleNamespace(trace=object(), traced=[_step(1.0, 2.0), _step(3.0, 4.0)])
INSIDE = ([_sample("gemm_launches", 1.5)] * 6 + [_sample("gemm_split_launches", 1.5)] * 4
          + [_sample("gemm_launches", 3.2, 4), _sample("gemm_split_launches", 3.9, 2)])
OUTSIDE = ([_sample("gemm_launches", 2.5, 100), _sample("gemm_split_launches", 0.5, 7),
            _sample("gemm_split_launches", 4.5, 7), _sample("moe_live_rows", 1.5, 9)])


@pytest.mark.parametrize("samples,run,want", [
    (INSIDE, RUN, 60.0),  # 6 of 10 launches split
    (INSIDE + OUTSIDE, RUN, 60.0),  # samples between or past the traced steps
    ([_sample("gemm_launches", 1.5)] * 3, RUN, 0.0),  # a stretch of 2048-row steps
    (OUTSIDE, RUN, None),  # none inside
    ([], RUN, None),  # a program without the counters (the parent's)
    (INSIDE, types.SimpleNamespace(trace=None, traced=[]), None),  # an untraced run
])
def test_reads_the_split_share_of_the_traced_steps(monkeypatch, samples, run, want):
    monkeypatch.setattr(counters, "program_samples", lambda: list(samples))
    got = registry.load_module("metrics", NAME).read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_its_entry_names_every_cell():
    with open(os.path.join(registry.ROOT, "BENCHMARK.json")) as f:
        entry, = [m for m in json.load(f)["per_layer"] if m["name"] == NAME]
    mod = registry.load_module("metrics", NAME)
    assert (entry["layer"], entry["unit"], entry["source"], entry["moves"]) == (
        mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES)
    assert entry["workloads"] == CELLS
    for cell in CELLS:
        assert NAME in {m["name"] for m in registry.load_cell(cell).per_layer}
