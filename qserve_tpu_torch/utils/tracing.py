"""Spans and counters of the serving path.

Spans time the host's phases inside `LLMEngine.step()`: where the step
schedules, packs its batch, issues the forward's launches, samples, waits
for the sampled ids and post-processes them. Each span holds its name, its
start and end on `time.perf_counter_ns()`, the span that encloses it (its
parent), the engine's step number and, where there is one, a request id;
the root span of a step, `engine.step`, also holds what kind of step it was
(`LLMEngine.last_step_kind`). A layer's self time is its span's duration
less its children's.

Spans record only while a torch.profiler records in the process, or after
an operator turned them on (`enable()`, or `LLMEngine(log_stats=True)`).
`LLMEngine.step()` reads the profiler's state once at its start
(`begin_step`); with spans off a span site costs one flag read and a no-op
context. Spans are kept in a bounded ring in memory (`RING` of them, more
than 10 s of Mixtral-8x7B decode steps, the ones with most spans), read by
`spans()` and emptied by `clear()`. They are plain Python, never
`record_function` ranges: a profiler with CUDA activity mirrors those onto
the device's timeline, where they would read as device work.

`spans()` gives each time twice: on `perf_counter` (the clock a caller
times its own steps with) and on the unix-ns clock that torch.profiler
stamps its CPU events with, through the offset between the two clocks
captured when spans turn on.

Counter samples (`count(name, n)`) go into the same ring: the counter's
name, n, the step number and the time, only while spans record. Each call
also adds n to the process's running total of the name (`totals()`,
always on, in `LLMEngine.stats()`). A CUDA graph's capture keeps the
samples its forward made (`captured_counts`) instead of recording them,
and each replay records them again (`replay_counts`), as the kernel launch
counts are added back (kernels/_build.LAUNCHES). `samples()` reads them.

Counters (`Counters`) count the scheduler's events: preemptions by mode,
pages swapped, prompt tokens skipped by a computed shared prefix or
computed in chunks, requests admitted and their wait in the queue. They
are plain integer adds, always on; each scheduler owns one set and
`LLMEngine.stats()` returns it, with the model runner's `DecodeCounters`,
its decode steps by how their forward ran (a replayed CUDA graph or eager
issue).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler

RING = 1 << 16

# The decode step's host phases, in the order the step runs them: the mean
# of each over an interval is the operator's log line (LLMEngine).
DECODE_PHASES = ("engine.schedule", "worker.cache_ops", "runner.pack", "runner.forward",
                 "runner.sample", "runner.readback", "engine.post")

_enabled = False  # an operator turned spans on
_on = False  # spans record: _enabled, or a profiler recorded at the step's start
_offset_ns = 0  # time.time_ns() - time.perf_counter_ns() when spans turned on
_step = 0  # the engine's step number
_next_id = 0
_open: List[int] = []  # ids of the open spans, innermost last
# (id, parent, name, step, start_ns, end_ns, request_id, kind, offset_ns,
#  value): value is None for a span, a counter sample's n otherwise
_ring: collections.deque = collections.deque(maxlen=RING)
_totals: Dict[str, int] = collections.Counter()
_captured: Optional[Dict[str, int]] = None  # a capture's samples, while one runs
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    parent: Optional[int]  # the enclosing span's id
    name: str
    step: int
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    unix_start_ns: int  # the same instants on torch.profiler's clock
    unix_end_ns: int
    request_id: Optional[str]
    kind: Optional[str]  # engine.step: the step's kind

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Open:
    """One span while it is open."""

    __slots__ = ("name", "request_id", "kind", "id", "parent", "start_ns")

    def __init__(self, name: str, request_id: Optional[str]) -> None:
        self.name = name
        self.request_id = request_id
        self.kind: Optional[str] = None

    def __enter__(self) -> "_Open":
        global _next_id
        self.id = _next_id
        _next_id += 1
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        _open.pop()
        _ring.append((self.id, self.parent, self.name, _step, self.start_ns, end,
                      self.request_id, self.kind, _offset_ns, None))


def span(name: str, request_id: Optional[str] = None):
    """`with span(name):` times the block while spans record; a no-op
    context otherwise. The open span (`as s`) takes a `kind`."""
    if not _on:
        return _OFF
    return _Open(name, request_id)


def record(name: str, start_ns: int, end_ns: int, request_id: Optional[str] = None) -> None:
    """A span measured elsewhere (a request's wait between two calls), with
    no parent; recorded only while spans record."""
    global _next_id
    if not _on:
        return
    _ring.append((_next_id, None, name, _step, start_ns, end_ns, request_id, None, _offset_ns,
                  None))
    _next_id += 1


class Sample(NamedTuple):
    """A counter sample: n more of `name` at one instant of a step."""

    name: str
    step: int
    t_ns: int  # time.perf_counter_ns()
    unix_ns: int  # the same instant on torch.profiler's clock
    value: int


def count(name: str, n: int) -> None:
    """n more of counter `name`: added to its running total, and while
    spans record, a sample in the ring. Inside `captured_counts` the sample
    is kept for the graph's replays instead."""
    global _next_id
    if _captured is not None:
        _captured[name] = _captured.get(name, 0) + n
        return
    _totals[name] += n
    if _on:
        t = time.perf_counter_ns()
        _ring.append((_next_id, None, name, _step, t, t, None, None, _offset_ns, n))
        _next_id += 1


@contextlib.contextmanager
def captured_counts():
    """Yields a dict that holds, on exit, the counts made inside (a CUDA
    graph's capture, which runs none of its work), summed by name; nothing
    inside is added to the totals or recorded."""
    global _captured
    outer, _captured = _captured, {}
    try:
        yield _captured
    finally:
        _captured = outer


def replay_counts(held: Dict[str, int]) -> None:
    """A replayed graph's counts: each name's total, one sample each."""
    for name, n in held.items():
        count(name, n)


def totals() -> Dict[str, int]:
    """The running total of every counter since the process started."""
    return dict(_totals)


def samples(since: int = -1) -> List[Sample]:
    """The counter samples in the ring, in the order they were made (of
    entries with an id above `since`)."""
    return [Sample(n, st, t0, t0 + off, v)
            for i, _, n, st, t0, _, _, _, off, v in list(_ring) if i > since and v is not None]


def _turn(on: bool) -> None:
    global _on, _offset_ns
    if on and not _on:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = on


def begin_step(step: int) -> bool:
    """Called at the start of each engine step: reads whether a profiler
    records and sets the step number; returns whether spans record."""
    global _step
    _step = step
    _turn(_enabled or _autograd_profiler._is_profiler_enabled)
    return _on


def enable() -> None:
    """Spans record from now on, profiler or not."""
    global _enabled
    _enabled = True
    _turn(True)


def disable() -> None:
    """Back to recording only under a profiler."""
    global _enabled
    _enabled = False
    _turn(_autograd_profiler._is_profiler_enabled)


def spans(since: int = -1) -> List[Span]:
    """The spans in the ring with an id above `since`, in the order they
    closed."""
    return [Span(i, p, n, st, t0, t1, t0 + off, t1 + off, rid, kind)
            for i, p, n, st, t0, t1, rid, kind, off, v in list(_ring) if i > since and v is None]


def clear() -> None:
    _ring.clear()


def step_means(all_spans: Iterable[Span], names: Iterable[str],
               kind: str = "decode") -> Tuple[int, Dict[str, float]]:
    """(steps, mean host ms a step of each name) over the steps of `kind`
    whose root span is among `all_spans`."""
    all_spans = list(all_spans)
    steps = {s.step for s in all_spans if s.name == "engine.step" and s.kind == kind}
    total = dict.fromkeys(names, 0)
    for s in all_spans:
        if s.step in steps and s.name in total:
            total[s.name] += s.duration_ns
    n = len(steps)
    return n, {k: v / 1e6 / n if n else 0.0 for k, v in total.items()}


@dataclasses.dataclass
class Counters:
    """A scheduler's event counts since it was built."""

    preempted_recompute: int = 0  # groups preempted by recompute
    preempted_swap: int = 0  # groups preempted by swapping out
    pages_swapped_out: int = 0
    pages_swapped_in: int = 0
    prefix_skipped_tokens: int = 0  # prompt tokens a computed shared prefix skipped
    chunk_prompt_tokens: int = 0  # prompt tokens computed in chunks
    admitted: int = 0  # requests whose prompt was first scheduled
    queue_wait_ns_sum: int = 0  # their waits from add_request to that step
    queue_wait_ns_max: int = 0

    def admit(self, group, now_ns: int) -> None:
        """A request's prompt is scheduled for the first time: count its
        wait and record its `request.queue` span."""
        wait = now_ns - group.queued_ns
        self.admitted += 1
        self.queue_wait_ns_sum += wait
        self.queue_wait_ns_max = max(self.queue_wait_ns_max, wait)
        record("request.queue", group.queued_ns, now_ns, group.request_id)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DecodeCounters:
    """Decode steps by how the model runner ran the forward; each runner
    owns one set. Their ratio is the share of decode steps the captured
    graphs serve."""

    decode_graph_replays: int = 0  # replayed a captured CUDA graph
    decode_eager_steps: int = 0  # issued layer by layer (no graph for the step)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)
