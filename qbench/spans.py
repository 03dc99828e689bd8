"""Readers of the program's own spans (qserve_tpu_torch/utils/tracing.py).

The program records its spans while torch.profiler records, so over the
traced stretch (`run.traced`), the steps the device metrics read. A reader
sums, over each traced decode step, the durations of the spans of one name
that start inside the step's [t0, t1] on the harness's clock (both are
`perf_counter`), and divides by the number of traced decode steps. It
returns None where the program records no such span (a program without
the tracing module, or a run with no trace).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def program_spans() -> list:
    """The spans the program holds, or [] where it has none."""
    try:
        from qserve_tpu_torch.utils import tracing
    except ImportError:
        return []
    return tracing.spans()


def _decode_steps(run) -> List[Tuple[int, int]]:
    return [(int(s.t0 * 1e9), int(s.t1 * 1e9)) for s in run.traced if s.kind == "decode"]


def per_decode_step_ms(name: str):
    """Host ms of the spans named `name` a traced decode step."""
    def read(run) -> Optional[float]:
        if run.trace is None:
            return None
        spans = sorted((s.start_ns, s.duration_ns) for s in program_spans() if s.name == name)
        steps = _decode_steps(run)
        if not spans or not steps:
            return None
        starts = [s for s, _ in spans]
        total = 0
        for t0, t1 in steps:
            lo, hi = bisect.bisect_left(starts, t0), bisect.bisect_right(starts, t1)
            total += sum(d for _, d in spans[lo:hi])
        return total / 1e6 / len(steps)
    return read


def coverage(run) -> Optional[float]:
    """The share of the harness's host time around the traced decode steps
    that the children of their `engine.step` spans cover."""
    spans = program_spans()
    roots = {s.id: s for s in spans if s.name == "engine.step" and s.kind == "decode"}
    steps = _decode_steps(run)
    if not roots or not steps:
        return None
    root_starts = sorted((r.start_ns, r.id) for r in roots.values())
    covered = 0
    for t0, t1 in steps:
        i = bisect.bisect_left(root_starts, (t0, -1))
        if i < len(root_starts) and root_starts[i][0] <= t1:
            rid = root_starts[i][1]
            covered += sum(s.duration_ns for s in spans if s.parent == rid)
    return covered / sum(t1 - t0 for t0, t1 in steps)
