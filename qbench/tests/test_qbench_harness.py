"""The harness end to end at tiny widths on the CPU, through the port's
plain paths: the reference agrees with what the engine served, and a run
whose timed path is broken underneath comes out not correct.

The tiny limits (TINY_LIMITS: widest gap, mean gap) sit far above the
sound runs' readings at these widths (widest 0 to 0.12, mean at most
0.0037 over six seeds, dense and MoE) and far below the faults' (the KV
append skipped: widest 3.8-6.1, mean 1.26-2.35); the cells' own limits
come from the chip (PERF.md)."""

import time

import pytest

from qbench import run as qrun
from qbench.tests.conftest import alter_tokens, drop_half_the_batch, skip_kv_append, tiny_cell

TINY_LIMITS = (1.0, 0.05)
SEEDS = (2**31 + 11, 5, 77)


def _run(cell, seed, trace=False, args=None, seconds=1.5):
    return qrun.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(), args=args,
                         num_pages=128)


@pytest.mark.parametrize("seed", SEEDS)
def test_dense_decode_batch_is_correct(seed):
    out = _run(tiny_cell(False, "decode-batch", TINY_LIMITS), seed)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"output_tok_s", "setup_s"}
    assert out["checks"]["mean_gap"]["tokens"] > 0
    assert list(out)[-1] == "checks"


def test_moe_masked_and_routed_are_correct():
    import dataclasses

    cell = tiny_cell(True, "decode-batch", TINY_LIMITS)
    assert _run(cell, 3)["correct"]
    # streams of 32 rows or more take the routed GEMMs in 16-row blocks
    routed = dataclasses.replace(cell.family.program(cell.config).args, moe_route_min_tokens=32,
                                 moe_route_block=16)
    out = _run(cell, 3, args=routed)
    assert out["correct"], out["checks"]


def test_chat_open_loop_reports_latency():
    cell = tiny_cell(False, "chat-bursty", TINY_LIMITS)
    cell.traffic["rate_per_s"] = 4.0
    cell.traffic["sampling"]["greedy_every"] = 2  # enough greedy requests finish to check
    out = _run(cell, 8, seconds=4.0)
    assert out["correct"], out["checks"]
    assert {"output_tok_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"} <= set(out["metrics"])
    assert out["attempted"] > 0 and out["failed"] == 0


def test_trace_run_reports_per_layer_metrics():
    out = _run(tiny_cell(False, "decode-batch", TINY_LIMITS), 4, trace=True)
    assert out["correct"]
    # host metrics read from the window; device ones need a card's trace
    assert {"decode_step_ms.batch", "decode_rows.batch",
            "launches_per_decode_step.batch"} <= set(out["metrics"])
    assert "breakdown" in out and "busy_s" in out["device"]


@pytest.mark.parametrize("fault", [alter_tokens, skip_kv_append, drop_half_the_batch])
@pytest.mark.parametrize("moe", [False, True])
def test_a_broken_timed_path_is_not_correct(fault, moe, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny_cell(moe, "decode-batch", TINY_LIMITS), SEEDS[0])
    assert not out["correct"], out["checks"]


def test_control_reads_wider_than_the_program():
    """The lower-precision control (int4 activations), read by the same gaps
    as the program, reads a wider mean gap than the program at tiny widths;
    at the cells' widths its readings are the limits' upper ones, and the
    card test sees the cells' limits judge it not correct (PERF.md)."""
    from qbench import calibrate

    prog, ctrl = [], []
    for seed in SEEDS:
        got = {}

        def checker(cell, seed, requests, device):
            got.update(calibrate.readings(cell, seed, requests, device))
            return True, {}

        qrun.run_cell(tiny_cell(False, "decode-batch", TINY_LIMITS), seed, 3.0, False, "cpu",
                      time.perf_counter(), num_pages=128, checker=checker)
        assert got["program_correct"], got
        prog.append(got["program_mean_gap"])
        ctrl.append(got["control_mean_gap"])
    assert min(ctrl) > 3 * max(prog)


def test_sweep_reads_one_rate():
    """The knee sweep's reading of one rate, on the tiny chat mix."""
    from qbench import harness, sweep

    cell = tiny_cell(False, "chat-bursty")
    engine = harness.build_engine(cell.family, cell.config, 1, "cpu", num_pages=128)
    line = sweep.one_rate(engine, cell.family, cell.config, cell.traffic, 4.0, 1.5, 1)
    assert "error" not in line, line
    assert line["due"] > 0 and line["ttft_p95_ms"] > 0 and line["max_running"] >= 1
