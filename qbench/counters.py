"""Readers of the program's counter samples (qserve_tpu_torch/utils/
tracing.py `count`): each holds a counter's n at one instant, recorded while
spans record, so over the traced stretch (`run.traced`). A reader sums the
samples of a name whose instant lies inside one of the traced steps' [t0,
t1] on the harness's clock (both are `perf_counter`). It returns None where
the program records no counter samples (a program without them, or a run
with no trace) or none of the names.
"""

from __future__ import annotations

import bisect
from typing import Optional


def program_samples() -> list:
    """The counter samples the program holds, or [] where it has none."""
    try:
        from qserve_tpu_torch.utils import tracing
    except ImportError:
        return []
    return tracing.samples() if hasattr(tracing, "samples") else []


def traced_sums(run, names) -> Optional[dict]:
    """{name: the sum of its samples inside the traced steps}."""
    if run.trace is None:
        return None
    steps = sorted((int(s.t0 * 1e9), int(s.t1 * 1e9)) for s in run.traced)
    starts = [a for a, _ in steps]
    sums = dict.fromkeys(names, 0)
    seen = False
    for smp in program_samples():
        if smp.name not in sums:
            continue
        i = bisect.bisect_right(starts, smp.t_ns) - 1
        if i >= 0 and smp.t_ns <= steps[i][1]:
            sums[smp.name] += smp.value
            seen = True
    return sums if seen else None


def share_pct(part: str, whole: str):
    """100 x the traced sum of counter `part` over that of `whole`."""
    def read(run) -> Optional[float]:
        sums = traced_sums(run, (part, whole))
        if not sums or sums[whole] <= 0:
            return None
        return 100.0 * sums[part] / sums[whole]
    return read
