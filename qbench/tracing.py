"""The traced window: torch.profiler over a stretch of steps, reduced to
summaries in memory (no trace file is written).

The harness marks its own spans with record_function: `qbench.trace`
around the whole stretch, `qbench.step` around each `LLMEngine.step()`,
and, inside it, `qbench.schedule` around the scheduler's call and
`qbench.execute` around the worker's; `qbench.wait` where an open loop
sleeps until its next arrival. Every operation the device ran (kernels,
copies, sets) counts as busy. Each idle stretch of the device is charged
to what the host was doing meanwhile: `execute.<kind>`, `schedule`,
`engine.<kind>` (the rest of a step: outputs, stop checks), `harness`
(between steps) or `wait`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch

TRACE_S = 6.0  # the traced stretch after the measured window


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]  # device seconds by kernel name
    idle_by_label: Dict[str, float]

    def device_s(self, patterns) -> float:
        """Device seconds of the kernels whose name holds any of patterns."""
        return sum(t for n, t in self.kernel_s.items() if any(p in n for p in patterns))

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])[:n]]


def _ns(e) -> Tuple[int, int]:
    s = e.start_ns()
    return s, s + e.duration_ns()


@contextlib.contextmanager
def traced(feeder):
    """Profile the steps the feeder runs inside; yields a holder whose
    `summary` is set on exit. The scheduler's and worker's calls are
    wrapped on the engine's instances for the stretch and restored after."""
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = feeder.engine
    sched, worker = eng.scheduler, eng.worker
    orig_schedule, orig_execute = sched.schedule, worker.execute_model

    def schedule(*a, **k):
        with record_function("qbench.schedule"):
            return orig_schedule(*a, **k)

    def execute(*a, **k):
        with record_function("qbench.execute"):
            return orig_execute(*a, **k)

    holder = type("Holder", (), {"summary": None})()
    first_step = len(feeder.steps)
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        sched.schedule, worker.execute_model = schedule, execute
        feeder.span = record_function
        with record_function("qbench.trace"):
            yield holder
            sync()
    finally:
        feeder.span = None
        sched.schedule, worker.execute_model = orig_schedule, orig_execute
        prof.__exit__(None, None, None)
    kinds = [s.kind for s in feeder.steps[first_step:]]
    holder.summary = summarize(prof.profiler.kineto_results.events(), kinds)


def summarize(events, kinds: List[str]) -> TraceSummary:
    """Reduce kineto events to busy time, kernel time by name and idle
    time by host label. `kinds` are the traced steps' kinds, in order."""
    dev: List[Tuple[int, int, str]] = []
    marks: Dict[str, List[Tuple[int, int]]] = {}
    for e in events:
        name = e.name()
        if name.startswith("qbench."):
            if str(e.device_type()).endswith("CPU"):
                marks.setdefault(name, []).append(_ns(e))
            continue
        if str(e.device_type()).endswith("CUDA"):
            s, t = _ns(e)
            if t > s:
                dev.append((s, t, name))
    (w0, w1), = marks["qbench.trace"]
    kernel_s: Dict[str, float] = {}
    ivs = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) * 1e-9
        ivs.append((s, t))
    busy, gaps = _union_and_gaps(sorted(ivs), w0, w1)
    labels = _host_labels(marks, kinds, w0, w1)
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, kernel_s=kernel_s,
                        idle_by_label=_charge(gaps, labels))


def _union_and_gaps(ivs, w0, w1):
    busy, gaps, cur = 0, [], w0
    cs = ce = None
    for s, t in ivs:
        if ce is None or s > ce:
            if ce is not None:
                busy += ce - cs
            if s > cur:
                gaps.append((cur, s))
            cs, ce = s, t
        else:
            ce = max(ce, t)
        cur = max(cur, ce)
    if ce is not None:
        busy += ce - cs
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _host_labels(marks, kinds, w0, w1) -> List[Tuple[int, int, str]]:
    """Disjoint host intervals covering [w0, w1], each with its label."""
    steps = sorted(marks.get("qbench.step", []))
    inner = sorted([(s, t, "schedule") for s, t in marks.get("qbench.schedule", [])]
                   + [(s, t, "execute") for s, t in marks.get("qbench.execute", [])])
    waits = sorted(marks.get("qbench.wait", []))
    out, cur = [], w0
    spans = sorted([(s, t, "step", i) for i, (s, t) in enumerate(steps)]
                   + [(s, t, "wait", -1) for s, t in waits])
    j = 0
    for s, t, what, i in spans:
        if s > cur:
            out.append((cur, s, "harness"))
        if what == "wait":
            out.append((max(s, cur), t, "wait"))
        else:
            kind = kinds[i] if i < len(kinds) else "none"
            c = max(s, cur)
            while j < len(inner) and inner[j][0] < s:
                j += 1
            while j < len(inner) and inner[j][1] <= t:
                a, b, lab = inner[j]
                if a > c:
                    out.append((c, a, f"engine.{kind}"))
                out.append((a, b, f"execute.{kind}" if lab == "execute" else "schedule"))
                c = b
                j += 1
            if t > c:
                out.append((c, t, f"engine.{kind}"))
        cur = max(cur, t)
    if w1 > cur:
        out.append((cur, w1, "harness"))
    return out


def _charge(gaps, labels) -> Dict[str, float]:
    """Seconds of each idle gap, split by the host label it overlaps."""
    out: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j < len(labels) and labels[j][1] <= a:
            j += 1
        k = j
        while k < len(labels) and labels[k][0] < b:
            s, t, lab = labels[k]
            ov = min(b, t) - max(a, s)
            if ov > 0:
                out[lab] = out.get(lab, 0.0) + ov * 1e-9
            k += 1
    return out
