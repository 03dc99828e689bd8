"""The per-layer metrics read from the program's own spans
(qbench/spans.py), on the tiny CPU cells through `--trace 1`'s path: each
comes back where its entry lists the cell, its file matches its entry, and
the spans under each traced decode step's `engine.step` cover the
harness's host time around that step."""

import os
import time

import pytest

from qbench import registry, spans
from qbench import run as qrun
from qbench.tests.conftest import tiny_cell

SPAN_METRICS = {"schedule_ms.batch": "engine.schedule", "runner_pack_ms.batch": "runner.pack",
                "forward_issue_ms.batch": "runner.forward",
                "readback_wait_ms.batch": "runner.readback",
                "engine_post_ms.batch": "engine.post"}
BENCH = registry.load_json(os.path.join(registry.ROOT, "BENCHMARK.json"))


def _traced_run(moe, monkeypatch):
    """A traced tiny run; returns its line and the view its metrics read."""
    views = []
    orig = qrun.RunView

    def keep(*a, **k):
        views.append(orig(*a, **k))
        return views[-1]

    monkeypatch.setattr(qrun, "RunView", keep)
    out = qrun.run_cell(tiny_cell(moe, "decode-batch", (1.0, 0.05)), 6, 1.5, True, "cpu",
                        time.perf_counter(), num_pages=128)
    return out, views[0]


@pytest.mark.parametrize("moe", [False, True])
def test_span_metrics_and_their_coverage(moe, monkeypatch):
    out, view = _traced_run(moe, monkeypatch)
    assert out["correct"], out["checks"]
    cell = "mixtral-8x7b.decode-batch" if moe else "mistral-7b.decode-batch"
    listed = {m["name"] for m in BENCH["per_layer"] if m["name"] in SPAN_METRICS
              and cell in m["workloads"]}
    assert listed == set(SPAN_METRICS)
    for name in listed:
        assert out["metrics"][name]["unit"] == "ms" and out["metrics"][name]["value"] > 0
    assert sum(1 for s in view.traced if s.kind == "decode") > 0
    cov = spans.coverage(view)
    assert 0.9 <= cov <= 1.0, cov
    # the phases add up to no more than the steps they sit in
    step_ms = 1e3 * sum(s.t1 - s.t0 for s in view.traced if s.kind == "decode") / sum(
        1 for s in view.traced if s.kind == "decode")
    parts = sum(out["metrics"][n]["value"] for n in ("schedule_ms.batch", "runner_pack_ms.batch",
                                                     "forward_issue_ms.batch",
                                                     "readback_wait_ms.batch",
                                                     "engine_post_ms.batch"))
    assert parts <= step_ms


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_entries_match_their_files(name):
    entry, = [m for m in BENCH["per_layer"] if m["name"] == name]
    mod = registry.load_module("metrics", name)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert entry["source"] == "program_span" and entry["better"] == "lower"
    assert f"`{SPAN_METRICS[name]}`" in mod.__doc__


def test_span_readers_read_nothing_without_spans(monkeypatch):
    """A program without the tracing module, or a run without a trace,
    gives no value and raises nothing."""
    from qbench.harness import Step

    view = qrun.RunView(sizes=None, family=None, kv_pages=1, t0=0.0, t1=1.0, setup_s=0.0,
                        window=[],
                        traced=[Step(0.0, 1.0, "decode", 0, [1], [], 1, 1, 1)],
                        trace=object(), due=[], finished=[])
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    for name in SPAN_METRICS:
        assert registry.load_module("metrics", name).read(view) is None
    assert spans.coverage(view) is None
