"""Readers shared by the metric files in qbench/e2e/ and qbench/metrics/.

A reader takes the run (qbench/run.py `RunView`) and returns a number, or
None where the run has nothing to read (no such step in the window, no
trace): the harness then leaves the metric out of the line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from qbench.roofline import gemm, paged_attention, peaks


def p95(values) -> Optional[float]:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95)) if len(values) else None


def step_ms(kinds):
    """Host ms around LLMEngine.step() of the window's steps of these kinds:
    their total time over their count."""
    def read(run):
        ts = [s.t1 - s.t0 for s in run.window if s.kind in kinds]
        return 1e3 * sum(ts) / len(ts) if ts else None
    return read


def decode_rows(run):
    rows = [len(s.decode_ctx) for s in run.window if s.kind == "decode"]
    return sum(rows) / len(rows) if rows else None


def kv_pages_peak(run):
    """100 x the most KV pages any of the window's steps left in use, over
    the cache's pages."""
    used = [s.pages_used for s in run.window]
    return 100.0 * max(used) / run.kv_pages if used and max(used) > 0 else None


def launches_per_decode_step(run):
    n = [s.launches for s in run.window if s.kind == "decode"]
    return sum(n) / len(n) if n else None


def _roofline(kernels, step_bound_s):
    """100 x the least time of the traced steps' launches of some kernels
    (their names), by the model family's count (step_bound_s(family)), over
    those kernels' device time in the trace."""
    def read(run):
        if run.trace is None:
            return None
        dev_s = run.trace.device_s(kernels)
        bound = sum(step_bound_s(run.family)(s, run.sizes) for s in run.traced)
        return 100.0 * bound / dev_s if dev_s > 0 and bound > 0 else None
    return read


paged_attn_roofline = _roofline(paged_attention.KERNELS, lambda f: f.paged_attn_bound_s)
gemm_roofline = _roofline(gemm.KERNELS, lambda f: f.gemm_bound_s)


def mfu(run):
    """100 x the model's ops in the traced stretch (its family's count) over
    its length at the int8 peak."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    ops = sum(run.family.step_ops(s, run.sizes) for s in run.traced)
    return 100.0 * ops / (run.trace.window_s * peaks.INT8_OPS) if ops > 0 else None


def device_idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
