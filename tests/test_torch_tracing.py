"""The serving step's spans and counters (qserve_tpu_torch/utils/tracing.py)
on a tiny CPU engine: spans record only under torch.profiler or once an
operator turns them on, nest as the step runs its phases, never reach the
profiler's own events, and sit on its clock; the scheduler's counters count
with spans off."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from qserve_tpu_torch.config import CacheConfig, QuantSpec, SchedulerConfig
from qserve_tpu_torch.engine.llm_engine import LLMEngine
from qserve_tpu_torch.models import llama, mixtral
from qserve_tpu_torch.sampling_params import SamplingParams
from qserve_tpu_torch.utils import tracing
from qserve_tpu_torch.worker.worker import Worker
import torch_port_util  # noqa: F401  (one torch thread a test process)

BS = 16
DENSE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
             num_heads=4, num_kv_heads=2, head_dim=16)
STEP_CHILDREN = {"engine.schedule", "engine.execute", "engine.post"}
RUNNER_CHILDREN = {"runner.pack", "runner.forward", "runner.sample", "runner.readback"}


@pytest.fixture(autouse=True)
def spans_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _engine(moe=False, pages=64, max_num_seqs=8, log_stats=False):
    args = llama.LlamaArgs(quant=QuantSpec.from_precision("w4a8kv4"), **DENSE,
                           **(dict(num_experts=4) if moe else {}))
    sc = SchedulerConfig(max_num_batched_tokens=64, max_num_seqs=max_num_seqs,
                         max_model_len=256)
    cc = CacheConfig(block_size=BS, num_device_pages=pages, quant=args.quant)
    params = mixtral.random_quantized_params(0, args, device="cpu") if moe else None
    worker = Worker.create(args, cc, sc, params=params, device="cpu")
    return LLMEngine(worker, sc, cc, log_stats=log_stats)


def _add(engine, lens, max_tokens=6, **sp):
    for i, n in enumerate(lens):
        engine.add_request(f"r{i}", prompt_token_ids=[1 + (7 * i + j) % 120 for j in range(n)],
                           sampling_params=SamplingParams(max_tokens=max_tokens,
                                                          ignore_eos=True, **sp))


def _drain(engine, limit=200):
    kinds = []
    while engine.has_unfinished_requests():
        engine.step()
        kinds.append(engine.last_step_kind)
        assert len(kinds) < limit, "engine did not converge"
    return kinds


def _profiled(engine):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kinds = _drain(engine)
    return kinds, prof


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_no_spans_without_a_profiler_and_counters_count():
    eng = _engine()
    _add(eng, (12, 20, 30))
    kinds = _drain(eng)
    assert "decode" in kinds
    assert tracing.spans() == []
    st = eng.stats()
    assert st["admitted"] == 3 and st["queue_wait_ns_sum"] >= st["queue_wait_ns_max"] > 0
    assert st["generated_tokens"] == 18 and st["preempted_recompute"] == 0


def test_a_decode_step_nests_its_phases_under_the_profiler():
    eng = _engine()
    _add(eng, (12, 20, 30))
    kinds, _ = _profiled(eng)
    spans = tracing.spans()
    roots = [s for s in spans if s.name == "engine.step"]
    assert [s.kind for s in roots] == kinds
    assert all(s.parent is None for s in roots)
    decode = [s for s in roots if s.kind == "decode"]
    assert decode
    for root in decode:
        kids = _children(spans, root)
        assert {s.name for s in kids} == STEP_CHILDREN and len(kids) == 3
        execute, = [s for s in kids if s.name == "engine.execute"]
        inner = _children(spans, execute)
        assert {s.name for s in inner} == RUNNER_CHILDREN and len(inner) == 4
        order = sorted(kids + inner, key=lambda s: s.start_ns)
        assert [s.name for s in order] == ["engine.schedule", "engine.execute", "runner.pack",
                                           "runner.forward", "runner.sample",
                                           "runner.readback", "engine.post"]
        for s in kids + inner:
            assert s.step == root.step
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    # the profiler stopped: the next step records nothing
    tracing.clear()
    _add(eng, (10,))
    _drain(eng)
    assert tracing.spans() == []


def test_moe_counts_once_per_layer_under_the_forward():
    """An eager MoE step's forward holds one `moe_live_rows`, one
    `moe_expert_rows` and, as every stream here takes the broadcast stream,
    one `moe_broadcast_layers` sample a layer, and no span of its own."""
    eng = _engine(moe=True)
    _add(eng, (12, 20))
    _profiled(eng)
    spans, samples = tracing.spans(), tracing.samples()
    forwards = [s for s in spans if s.name == "runner.forward"]
    assert forwards
    for fwd in forwards:
        assert _children(spans, fwd) == []
        inside = [s.name for s in samples
                  if s.step == fwd.step and fwd.start_ns <= s.t_ns <= fwd.end_ns]
        assert inside == (["moe_live_rows", "moe_expert_rows", "moe_broadcast_layers"]
                          * DENSE["num_layers"])


def test_moe_masked_dispatch_and_counter_samples_under_the_profiler():
    """Each MoE layer counts its live rows, T k, and the rows its experts
    computed for tokens: T NE, the masked loop's count, which the broadcast
    stream every stream here takes keeps (one `moe_broadcast_layers` a
    layer); the samples sit inside their step's forward and the totals
    grow by as much."""
    eng = _engine(moe=True)
    before = tracing.totals()
    _add(eng, (12, 20))
    _profiled(eng)
    spans, samples = tracing.spans(), tracing.samples()
    assert all(s.value is not None for s in samples) and samples
    fwd = {s.step: s for s in spans if s.name == "runner.forward"}
    live = [s for s in samples if s.name == "moe_live_rows"]
    rows = [s for s in samples if s.name == "moe_expert_rows"]
    broadcast = [s for s in samples if s.name == "moe_broadcast_layers"]
    assert len(live) == len(rows) == len(broadcast) == len(fwd) * DENSE["num_layers"]
    for a, b in zip(live, rows):
        T = a.value // 2  # top-2
        assert a.step == b.step and b.value == T * 4  # T NE of 4 experts: masked
        f = fwd[a.step]
        assert f.start_ns <= a.t_ns <= f.end_ns
    after = tracing.totals()
    assert after["moe_live_rows"] - before.get("moe_live_rows", 0) == sum(s.value for s in live)


def test_counts_without_spans_reach_the_totals_only():
    before = tracing.totals().get("x_test", 0)
    tracing.count("x_test", 5)
    assert tracing.samples() == [] and tracing.totals()["x_test"] == before + 5
    tracing.enable()
    tracing.count("x_test", 2)
    (smp,) = tracing.samples()
    assert (smp.name, smp.value) == ("x_test", 2) and tracing.spans() == []
    assert smp.unix_ns - smp.t_ns == tracing._offset_ns


def test_a_capture_keeps_its_counts_for_each_replay():
    """A graph's capture runs nothing: its counts are held, not added; each
    replay adds them back, one sample a name while spans record."""
    tracing.enable()
    before = tracing.totals().get("y_test", 0)
    with tracing.captured_counts() as held:
        tracing.count("y_test", 3)
        tracing.count("y_test", 4)
        tracing.count("z_test", 1)
    assert held == {"y_test": 7, "z_test": 1}
    assert tracing.totals().get("y_test", 0) == before and tracing.samples() == []
    tracing.replay_counts(held)
    tracing.replay_counts(held)
    assert tracing.totals()["y_test"] == before + 14
    assert [(s.name, s.value) for s in tracing.samples()] == [("y_test", 7), ("z_test", 1)] * 2


def test_request_queue_span_per_request():
    eng = _engine(max_num_seqs=2)
    _add(eng, (12, 20, 30, 9))
    _profiled(eng)
    queue = [s for s in tracing.spans() if s.name == "request.queue"]
    assert sorted(s.request_id for s in queue) == ["r0", "r1", "r2", "r3"]
    assert all(s.parent is None and s.end_ns >= s.start_ns for s in queue)
    # with two sequences at a time the last two wait for a finished one
    waits = {s.request_id: s.duration_ns for s in queue}
    assert waits["r3"] > waits["r0"]
    assert eng.stats()["queue_wait_ns_max"] == max(waits.values())


def test_no_profiler_event_carries_a_span_name():
    eng = _engine(moe=True)
    _add(eng, (12, 20))
    _, prof = _profiled(eng)
    names = {s.name for s in tracing.spans()}
    assert {"engine.step", "runner.forward", "runner.sample"} <= names
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not names & events


def test_span_times_sit_on_the_profiler_clock():
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe.warmup"):  # the first range loads its op
            pass
        with record_function("probe.marker"), tracing.span("probe.span"):
            torch.ones(4).sum()
    mark, = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe.marker"]
    probe, = [s for s in tracing.spans() if s.name == "probe.span"]
    assert abs(probe.unix_start_ns - mark.start_ns()) < 1_000_000
    assert probe.unix_end_ns - probe.unix_start_ns == probe.duration_ns


def test_small_cache_preempts_by_recompute():
    # 8 pages of 16 tokens cannot hold four 30-token prompts growing by 24
    eng = _engine(pages=8)
    _add(eng, (30, 30, 30, 30), max_tokens=24)
    _drain(eng, limit=500)
    st = eng.stats()
    assert st["preempted_recompute"] > 0 and st["preempted_swap"] == 0
    assert st["generated_tokens"] >= 4 * 24 and st["admitted"] == 4


def test_a_forked_request_times_its_page_copies():
    eng = _engine()
    _add(eng, (20,), best_of=2, n=2, temperature=1.0)
    _profiled(eng)
    spans = tracing.spans()
    ops = [s for s in spans if s.name == "worker.cache_ops"]
    assert ops
    parents = {s.id: s.name for s in spans}
    assert {parents[s.parent] for s in ops} == {"engine.execute"}


def test_operator_log_line_reads_spans_and_counters(monkeypatch):
    from qserve_tpu_torch.engine import llm_engine

    lines = []
    monkeypatch.setattr(llm_engine.logger, "info", lambda msg, *a: lines.append(msg % a))
    eng = _engine(log_stats=True, max_num_seqs=2)
    eng._stats_interval_s = 0.0
    _add(eng, (12, 20, 30))
    _drain(eng)
    phases = [line for line in lines if line.startswith("decode step host ms")]
    assert len(phases) == len(lines) // 2 > 0
    # every decode step is read by exactly one interval's line
    steps = sum(int(line.split("(")[1].split(" ")[0]) for line in phases)
    n, ms = tracing.step_means(tracing.spans(), tracing.DECODE_PHASES)
    assert steps == n > 0 and ms["runner.forward"] > 0
    assert sum(int(line.split("(")[-1].split(" ")[0]) for line in phases) == 3  # admitted
