"""The decode step's CUDA graphs (worker/model_runner.py `DecodeGraph`).

On the CPU: which steps take a graph and which issue eagerly (the CPU, tp
> 1, prefill / chunk / mixed steps, a batch with no graph), that a replaced
cache raises, the full-width table the graph path packs, the device feed into
the static tokens, the launch accounting, and that the plain decode gives
the same logits at the padded width as at the narrow one. A graph here is
`EagerGraph`: the same static buffers and calls, its forward run eagerly
at each replay.

On the card (`card`): replayed logits and appended KV rows bit for bit
against eager `llama.decode` at the same padded shapes, over two steps with
new tokens and longer contexts, for a small dense model and a small
Mixtral at W4A8KV4, and the profiler's count of the kernels a replay runs
against an eager step's (the launch counters only add a capture's
record). This file imports no JAX, so it runs on a machine
without it: `python -m pytest --noconftest tests/test_torch_decode_graph.py`.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from qserve_tpu_torch import native
from qserve_tpu_torch.config import CacheConfig, QuantSpec, SchedulerConfig
from qserve_tpu_torch.engine.llm_engine import LLMEngine
from qserve_tpu_torch.kernels import _build
from qserve_tpu_torch.kernels import kv_cache as kvc
from qserve_tpu_torch.models import llama, mixtral
from qserve_tpu_torch.sampling_params import SamplingParams
from qserve_tpu_torch.utils import tracing
from qserve_tpu_torch.worker import model_runner as mr
from qserve_tpu_torch.worker.worker import Worker
import torch_port_util  # noqa: F401  (one torch thread a test process)

BS = 16
GEO = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=32)
# the card's small models: widths the kernels take
CARD_GEO = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


class EagerGraph(mr.DecodeGraph):
    """A DecodeGraph whose replay runs its forward eagerly (the CPU has no
    graphs); it records the static tokens each replay read."""

    def capture(self, forward, pool, stream):
        self.forward, self.read = forward, []

    def replay(self):
        self.read.append(self.inputs[0].clone())
        self.logits = self.forward()
        return self.logits


def _args(**kw):
    return llama.LlamaArgs(quant=QuantSpec.from_precision("w4a8kv4"), **dict(GEO, **kw))


@pytest.fixture(scope="module")
def params():
    return llama.random_quantized_params(0, _args(), device="cpu")


def _engine(params, max_num_seqs=8, benchmarking=False, **sched):
    args = _args()
    sc = SchedulerConfig(**dict(dict(max_num_batched_tokens=256, max_num_seqs=max_num_seqs,
                                     max_model_len=256, enable_chunked_prefill=False),
                                **sched))
    cc = CacheConfig(block_size=BS, num_device_pages=64, quant=args.quant)
    worker = Worker.create(args, cc, sc, params=params, device="cpu",
                           benchmarking=benchmarking)
    return LLMEngine(worker, sc, cc)


def _install(engine, buckets):
    """EagerGraphs of these padded batches over the engine's cache, as
    capture_decode_graphs would capture them on the card."""
    runner, ce = engine.worker.model_runner, engine.worker.cache_engine
    runner._graphs = {}
    for B in buckets:
        g = EagerGraph(B, runner.max_pages_per_seq, runner.device)
        g.capture(lambda g=g: llama.decode(runner.params, ce.cache, *g.inputs,
                                           runner.model_args)[0], None, None)
        runner._graphs[B] = g
    runner._graph_cache = mr._cache_ptrs(ce.cache)
    return runner._graphs


def _add(engine, lens, max_tokens=6, seed=0):
    r = np.random.default_rng(seed)
    for i, n in enumerate(lens):
        engine.add_request(f"r{i}", prompt_token_ids=r.integers(1, 128, n).tolist(),
                           sampling_params=SamplingParams(temperature=0.0,
                                                          max_tokens=max_tokens,
                                                          ignore_eos=True))


def _drain(engine, limit=200):
    kinds = []
    while engine.has_unfinished_requests():
        engine.step()
        kinds.append(engine.last_step_kind)
        assert len(kinds) < limit
    return kinds


def _counts(engine):
    c = engine.worker.model_runner.decode_counts
    return c.decode_graph_replays, c.decode_eager_steps


# ---------------------------------------------------------------------------
# CPU: which steps take a graph


@pytest.mark.parametrize("max_num_seqs,want", [
    (128, [1, 2, 4, 8, 16, 32, 64, 128]), (6, [1, 2, 4, 6]), (1, [1])])
def test_graph_buckets_are_every_padded_batch(params, max_num_seqs, want):
    runner = _engine(params, max_num_seqs=max_num_seqs).worker.model_runner
    assert runner.graph_buckets() == want
    assert sorted({mr.bucket(n, 1, max_num_seqs) for n in range(1, max_num_seqs + 1)}) == want


def test_the_cpu_captures_nothing_and_decodes_eagerly(params):
    engine = _engine(params)
    assert engine.worker.model_runner._graphs == {}
    r0, e0 = _counts(engine)
    _add(engine, (12, 20, 30))
    kinds = _drain(engine)
    decodes = kinds.count("decode")
    assert decodes > 0
    assert _counts(engine) == (r0, e0 + decodes)
    st = engine.stats()
    assert (st["decode_graph_replays"], st["decode_eager_steps"]) == (r0, e0 + decodes)


def test_tensor_parallel_runner_captures_nothing(params):
    """tp_size > 1 keeps the eager decode even on a CUDA device (the gate
    returns before any CUDA call, so this runs on the CPU)."""
    engine = _engine(params)
    runner = engine.worker.model_runner
    runner.model_args = dataclasses.replace(runner.model_args, tp_size=2)
    runner.device = torch.device("cuda")
    runner.capture_decode_graphs(engine.worker.cache_engine)
    assert runner._graphs == {}


def test_pure_decode_steps_replay_and_prompt_steps_stay_eager(params, monkeypatch):
    """Every decode step replays its bucket's graph; prefill, chunk and
    mixed steps never touch a graph and run the model's own calls."""
    engine = _engine(params, max_num_batched_tokens=32, enable_chunked_prefill=True)
    graphs = _install(engine, engine.worker.model_runner.graph_buckets())
    calls = []
    for name in ("prefill", "prefill_chunk", "prefill_chunk_with_decode"):
        real = getattr(llama, name)
        monkeypatch.setattr(llama, name, lambda *a, _r=real, _n=name, **k:
                            (calls.append(_n), _r(*a, **k))[1])
    r0, e0 = _counts(engine)
    # a 50-token prompt alone: its first chunk, the chunk after, decode;
    # then a 40-token one admits in chunks beside its decode
    _add(engine, (50,), max_tokens=20)
    kinds = []
    for _ in range(4):
        engine.step()
        kinds.append(engine.last_step_kind)
    engine.add_request("b", prompt_token_ids=list(range(1, 41)),
                       sampling_params=SamplingParams(temperature=0.0, max_tokens=8,
                                                      ignore_eos=True))
    kinds += _drain(engine)
    assert {"prefill", "chunk", "mixed", "decode"} <= set(kinds)
    replays = sum(len(g.read) for g in graphs.values())
    assert replays == kinds.count("decode")
    assert _counts(engine) == (r0 + replays, e0)
    assert calls == [{"prefill": "prefill", "chunk": "prefill_chunk",
                      "mixed": "prefill_chunk_with_decode"}[k] for k in kinds if k != "decode"]


@pytest.mark.parametrize("graphs", [True, False], ids=["replay", "eager"])
def test_a_replay_runs_in_its_own_span_under_the_forward(params, graphs):
    """With spans on, each replayed decode step opens one
    `runner.graph_replay` inside its `runner.forward` (what the benchmark's
    decode_graph_share reads); an eager decode step opens none."""
    engine = _engine(params)
    if graphs:
        _install(engine, engine.worker.model_runner.graph_buckets())
    _add(engine, (12, 20, 30))
    tracing.clear()
    tracing.enable()
    try:
        kinds = _drain(engine)
        recorded = tracing.spans()
    finally:
        tracing.disable()
        tracing.clear()
    by_id = {s.id: s for s in recorded}
    replays = [s for s in recorded if s.name == "runner.graph_replay"]
    assert len(replays) == (kinds.count("decode") if graphs else 0)
    assert all(by_id[s.parent].name == "runner.forward" for s in replays)
    assert len({s.step for s in replays}) == len(replays)


def test_a_batch_past_the_largest_graph_decodes_eagerly(params):
    engine = _engine(params)
    graphs = _install(engine, [1, 2])
    _add(engine, (12, 20, 30))  # 3 rows: bucket 4, no graph
    r0, e0 = _counts(engine)
    kinds = _drain(engine)
    assert all(not g.read for g in graphs.values())
    assert _counts(engine) == (r0, e0 + kinds.count("decode"))
    _add(engine, (12, 20))  # 2 rows: bucket 2
    kinds = _drain(engine)
    assert len(graphs[2].read) == kinds.count("decode") > 0


def test_a_replaced_cache_is_captured_again(params):
    """Graphs record the cache's pointers and every step updates the
    cache's tensors in place: a decode step that finds new cache tensors
    is never replayed over the old ones, nor captured again; it raises."""
    engine = _engine(params)
    graphs = _install(engine, [1, 2, 4, 8])
    ce = engine.worker.cache_engine
    _add(engine, (12, 20))
    engine.step()  # the prefill: same tensors, updated in place
    assert mr._cache_ptrs(ce.cache) == engine.worker.model_runner._graph_cache
    ce.cache = kvc.KVCache(ce.cache.data.clone(), ce.cache.scales.clone())
    with pytest.raises(RuntimeError, match="decode graphs"):
        engine.step()
    assert all(not g.read for g in graphs.values())
    assert _counts(engine) == (0, 0)


def test_the_graph_path_packs_the_full_table(params):
    """The static table is max_pages_per_seq wide: each row's pages, then
    zeros; padding rows have ctx 0."""
    engine = _engine(params)
    graphs = _install(engine, [4])
    _add(engine, (12, 40, 30), max_tokens=2)
    engine.step()  # the prefill
    md, sched = engine.scheduler.schedule()
    engine.worker.execute_model(md, sched)
    tok, bt, cl = graphs[4].inputs
    runner = engine.worker.model_runner
    assert bt.shape == (4, runner.max_pages_per_seq) == (4, 16)
    rows = [(d.get_last_token_id(), d.get_len(), m.block_tables[sid])
            for m in md for sid, d in m.seq_data.items()]
    for i, (t, n, table) in enumerate(rows):
        assert int(cl[i]) == n and int(tok[i]) == t
        assert bt[i, :len(table)].tolist() == table and not bt[i, len(table):].any()
    assert int(cl[3]) == 0 and not bt[3].any()


def test_device_feed_copies_the_sampled_ids_into_the_static_tokens(params):
    engine = _engine(params, benchmarking=True)
    graphs = _install(engine, [4])
    runner = engine.worker.model_runner
    _add(engine, (12, 20, 30), max_tokens=5)
    engine.step()
    prev = []
    while engine.has_unfinished_requests():
        engine.step()
        prev.append(runner._prev_toks.clone())
    read = graphs[4].read
    assert len(read) == len(prev) >= 3
    # the first decode step reads the host's tokens; each later one the
    # ids the step before sampled, as they stayed on the device
    for got, want in zip(read[1:], prev):
        assert torch.equal(got, want)


def test_eager_graph_decode_matches_eager_narrow_decode(params):
    """Plain decode logits with the table padded to max_pages_per_seq
    against the narrow table, within the attention tests' atol; the KV
    rows appended are the same bytes."""
    args = _args()
    cache = kvc.create_kv_cache(2, 64, 2, BS, 32, device="cpu")
    g = torch.Generator().manual_seed(1)
    data = torch.randint(-128, 128, cache.data.shape, generator=g, dtype=torch.int8)
    scales = torch.rand(cache.scales.shape, generator=g) * 0.05 + 0.01
    a = kvc.KVCache(data.clone(), scales.to(cache.scales.dtype))
    b = kvc.KVCache(a.data.clone(), a.scales.clone())
    ctx = [9, 33, 17]
    tables = [[5, 6], [1, 2, 3], [7, 8]]
    toks = [3, 4, 5]
    out = []
    for cache_, width in ((a, 3), (b, 16)):
        tok, cl, bt = native.pack_decode(toks, ctx, tables, 4, width)
        logits, _ = llama.decode(params, cache_, *map(torch.from_numpy, (tok, bt, cl)), args)
        out.append(logits)
    np.testing.assert_allclose(out[0][:3].float().numpy(), out[1][:3].float().numpy(),
                               atol=2e-2)
    assert torch.equal(a.data, b.data) and torch.equal(a.scales, b.scales)


def test_capture_takes_its_launches_off_the_count_and_replays_add_them():
    _build.count_launch("k_before")
    before = dict(_build.LAUNCHES)
    with _build.captured_launches() as counts:
        _build.count_launch("k_a")
        _build.count_launch("k_a")
        _build.count_launch("k_before")
    assert dict(_build.LAUNCHES) == before
    assert dict(counts) == {"k_a": 2, "k_before": 1}
    _build.LAUNCHES.update(counts)
    assert _build.LAUNCHES["k_a"] == before.get("k_a", 0) + 2
    assert _build.LAUNCHES["k_before"] == before["k_before"] + 1


# ---------------------------------------------------------------------------
# the card: replay against eager, bit for bit


def _card_model(moe: bool):
    geo = dict(CARD_GEO)
    if moe:  # streams of 16 rows or more route (B = 128: broadcast), shorter ones loop
        geo.update(num_experts=4, moe_top_k=2, moe_route_block=128, moe_route_min_tokens=16)
    args = llama.LlamaArgs(quant=QuantSpec.from_precision("w4a8kv4"), **geo)
    make = mixtral.random_quantized_params if moe else llama.random_quantized_params
    return args, make(0, args, device="cuda")


def _kernels(fn):
    """fn()'s result and the device kernels it ran, by name and count, as
    torch.profiler's CUDA activity saw them. Copies and fills are left out:
    a graph may run a captured copy as a driver kernel (`memcpy32_post`)
    where the eager step ran a cudaMemcpy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.lower().startswith(("memcpy", "memset")))


@pytest.mark.card
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "mixtral"])
def test_replay_matches_eager_bit_for_bit(card, moe):
    """Graphs at B = 128, 8, 1 (captured largest first into one pool) over
    one cache, eager `llama.decode` over a copy at the same full-width
    table: equal logits and equal caches after each of two steps, the
    second with new tokens and every context one longer (it reads the row
    the first appended); a padding row at B > 1; the replay's launches
    are the eager step's, by the counters and by the profiler."""
    args, params = _card_model(moe)
    maxP, P = 16, 512
    ga = torch.Generator(device=card).manual_seed(2)
    cache = kvc.create_kv_cache(args.num_layers, P, args.num_kv_heads, BS, args.head_dim,
                                device=card)
    cache.data.copy_(torch.randint(-128, 128, cache.data.shape, generator=ga,
                                   device=card, dtype=torch.int8))
    cache.scales.copy_(torch.rand(cache.scales.shape, generator=ga, device=card) * 0.05 + 0.01)
    eager = kvc.KVCache(cache.data.clone(), cache.scales.clone())
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
    graphs = {}
    for B in (128, 8, 1):
        g = mr.DecodeGraph(B, maxP, card)
        g.capture(lambda g=g: llama.decode(params, cache, *g.inputs, args)[0], pool, stream)
        graphs[B] = g
    rng = np.random.default_rng(3)
    for B in (1, 8, 128):
        n = max(B - 1, 1)
        pages = rng.permutation(P)[: n * 4].reshape(n, 4)
        ctx = rng.integers(2, 4 * BS - 2, n)
        tables = [pages[i, : -(-(c + 1) // BS)].tolist() for i, c in enumerate(ctx)]
        prev = None
        for step in range(2):
            toks = rng.integers(1, args.vocab_size, n).tolist()
            tok, cl, bt = native.pack_decode(toks, (ctx + step).tolist(), tables, B, maxP)
            inputs = [torch.from_numpy(a).to(card) for a in (tok, bt, cl)]
            graphs[B].load(tok, bt, cl)
            l0 = dict(_build.LAUNCHES)
            (want, _), k_eager = _kernels(lambda: llama.decode(params, eager, *inputs, args))
            ran = {k: v - l0.get(k, 0) for k, v in _build.LAUNCHES.items() if v != l0.get(k, 0)}
            l1 = dict(_build.LAUNCHES)
            got, k_replay = _kernels(graphs[B].replay)
            got = got.clone()
            assert {k: v - l1.get(k, 0) for k, v in _build.LAUNCHES.items()
                    if v != l1.get(k, 0)} == ran == dict(graphs[B].launches)
            # the witness the counters are not: the profiler sees the replay
            # run the eager step's kernels, each as often
            assert k_replay == k_eager and sum(k_eager.values()) >= sum(ran.values()), \
                (k_replay - k_eager, k_eager - k_replay)
            assert torch.equal(got, want), (B, step, (got - want).abs().max())
            assert torch.equal(cache.data, eager.data) and torch.equal(cache.scales, eager.scales)
            if prev is not None:
                assert not torch.equal(got[:n], prev[:n])
            prev = got


@pytest.mark.card
def test_engine_on_the_card_replays_every_decode_step(card):
    """An engine built on the card captures its graphs with the worker and
    serves every pure decode step from them."""
    args, params = _card_model(False)
    sc = SchedulerConfig(max_num_batched_tokens=256, max_num_seqs=8, max_model_len=256)
    cc = CacheConfig(block_size=BS, num_device_pages=64, quant=args.quant)
    engine = LLMEngine(Worker.create(args, cc, sc, params=params, device=card), sc, cc)
    assert sorted(engine.worker.model_runner._graphs) == [1, 2, 4, 8]
    r0, e0 = _counts(engine)
    _add(engine, (12, 20, 30, 40, 50), max_tokens=10)
    kinds = _drain(engine)
    assert _counts(engine) == (r0 + kinds.count("decode"), e0)


@pytest.mark.card
def test_vlm_text_decode_replays_the_graphs(card):
    """The VLM runner inherits the decode step: an image request's prompt
    runs the spliced prefill eagerly, its decode steps replay the graphs
    the worker captured over the LLM."""
    from qserve_tpu_torch.models import clip, mm_projector, vila
    from qserve_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX

    largs, _ = _card_model(False)
    vargs = clip.VisionArgs(hidden_size=64, intermediate_size=128, num_layers=2,
                            num_heads=4, image_size=32, patch_size=8)
    args = vila.VilaArgs(largs, vargs, mm_projector.ProjectorArgs(
        "mlp_downsample", 64, 256, grid=vargs.grid))
    sc = SchedulerConfig(max_num_batched_tokens=256, max_num_seqs=4, max_model_len=256)
    cc = CacheConfig(block_size=BS, num_device_pages=64, quant=largs.quant)
    worker = Worker.create_vlm(args, cc, sc, params=vila.random_params(0, args, device=card),
                               device=card)
    engine = LLMEngine(worker, sc, cc)
    assert sorted(worker.model_runner._graphs) == [1, 2, 4]
    pix = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(np.float32)
    engine.add_request("i", prompt_token_ids=[1, IMAGE_TOKEN_INDEX, 2, 3],
                       sampling_params=SamplingParams(temperature=0.0, max_tokens=6,
                                                      ignore_eos=True),
                       multi_modal_data={"images": [pix[0]], "pixel_values": pix})
    r0, e0 = _counts(engine)
    kinds = _drain(engine)
    assert kinds[0] == "prefill" and kinds.count("decode") == 5
    assert _counts(engine) == (r0 + 5, e0)
