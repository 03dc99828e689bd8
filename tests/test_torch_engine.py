"""Port parity at the engine: the JAX package's LLMEngine and the port's,
on the same tiny quantized params, give identical greedy token streams,
with whole-prompt prefill and with chunked prefill, mixed chunk+decode
steps and prefix compute-skip, at W4A8KV4 per-channel and at the other
precisions (per-group W4, the W8 lm_head, W8A8, W16A16, KV8). Also that
EngineArgs serves every precision string, and the port's refusals: what the port does
not serve (engine-level data parallelism, a VLM at tp > 1, omit_vision_tower)
raises NotImplementedError naming ROADMAP."""

import numpy as np
import pytest
import torch

from qserve_tpu.config import CacheConfig as JCacheConfig
from qserve_tpu.config import SchedulerConfig as JSchedulerConfig
from qserve_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qserve_tpu.sampling_params import SamplingParams as JSamplingParams
from qserve_tpu.worker.worker import Worker as JWorker
from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
from qserve_tpu_torch.engine.arg_utils import EngineArgs
from qserve_tpu_torch.engine.llm_engine import LLMEngine
from qserve_tpu_torch.sampling_params import SamplingParams
from qserve_tpu_torch.worker.worker import Worker
from torch_port_util import TINY, tiny_pair

BS = 16
SCHED = dict(max_num_batched_tokens=256, max_num_seqs=8, max_model_len=256,
             enable_chunked_prefill=False)


def _port_engine(targs, tparams, **sched):
    sc = SchedulerConfig(**dict(SCHED, **sched))
    cc = CacheConfig(block_size=BS, num_device_pages=64, quant=targs.quant)
    worker = Worker.create(targs, cc, sc, params=tparams, device="cpu")
    return LLMEngine(worker, sc, cc)


def _run(engine, prompts, sp_cls, max_steps=200, **sp):
    for i, p in enumerate(prompts):
        engine.add_request(f"r{i}", prompt_token_ids=p,
                           sampling_params=sp_cls(**sp))
    outs, steps = {}, 0
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                outs[out.request_id] = out.outputs[0]["token_ids"]
        steps += 1
        assert steps < max_steps, "engine did not converge"
    return outs


def _prompts(n=4, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(1, TINY["vocab_size"], int(L)).tolist()
            for L in r.integers(5, 40, n)]


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def test_identical_greedy_streams(pair):
    """Exact on these prompts. The two sides sum some f32 products in other
    orders (attention, RMSNorm), so a bf16 value can land a neighbour apart
    and move this flat tiny model's logits by ~5e-3; where the top two
    logits are closer than that the argmax can differ (test_torch_llama
    checks the logits and the argmax away from such ties)."""
    jargs, jparams, targs, tparams = pair
    sc = JSchedulerConfig(**SCHED)
    cc = JCacheConfig(block_size=BS, num_device_pages=64, quant=jargs.quant)
    jengine = JLLMEngine(JWorker.create(jargs, cc, sc, params=jparams), sc, cc)
    prompts = _prompts(4, seed=1)  # the widest top-2 logit gaps of 11 seeds
    want = _run(jengine, prompts, JSamplingParams, max_tokens=8, temperature=0.0)
    got = _run(_port_engine(targs, tparams), prompts, SamplingParams,
               max_tokens=8, temperature=0.0)
    assert len(want) == 4
    assert got == want


def test_temperature_and_filtered_sampling_on_cpu(pair):
    """Raw temperature and top-k/top-p both run on CPU tensors (the plain
    threshold_mask; CUDA tensors take the filtered-sampler kernel)."""
    _, _, targs, tparams = pair
    outs = _run(_port_engine(targs, tparams), _prompts(2, seed=1), SamplingParams,
                max_tokens=5, temperature=0.8, top_k=5, top_p=0.9)
    assert all(len(t) == 5 for t in outs.values())
    outs = _run(_port_engine(targs, tparams), _prompts(2, seed=2), SamplingParams,
                max_tokens=5, temperature=0.8)
    assert all(len(t) == 5 for t in outs.values())


CHUNKED = dict(max_num_batched_tokens=32, enable_chunked_prefill=True)


def _jax_engine(jargs, jparams, **sched):
    sc = JSchedulerConfig(**dict(SCHED, **sched))
    cc = JCacheConfig(block_size=BS, num_device_pages=64, quant=jargs.quant)
    return JLLMEngine(JWorker.create(jargs, cc, sc, params=jparams), sc, cc)


def _run_staggered(engine, prompts, sp_cls):
    """The first prompt starts decoding, then the others arrive: with a
    32-token budget the long ones admit in chunks that ride with it."""
    kw = dict(temperature=0.0, ignore_eos=True)
    engine.add_request("s", prompt_token_ids=prompts[0],
                       sampling_params=sp_cls(max_tokens=20, **kw))
    engine.step()
    for i, p in enumerate(prompts[1:]):
        engine.add_request(f"r{i}", prompt_token_ids=p,
                           sampling_params=sp_cls(max_tokens=8, **kw))
    outs, kinds = {}, []
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                outs[out.request_id] = out.outputs[0]["token_ids"]
        kinds.append(getattr(engine, "last_step_kind", None))
        assert len(kinds) < 200, "engine did not converge"
    return outs, kinds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_prefill_matches_jax_engine(pair, seed):
    """Chunked against chunked: both engines take the same steps (a 100- and
    a 45-token prompt in 32-token chunks mixed with a running decode), so
    the greedy streams are identical on these prompts. 6 of 8 seeds agree;
    the other two break on a near-tie of this flat tiny model's logits, as
    in test_identical_greedy_streams."""
    jargs, jparams, targs, tparams = pair
    r = np.random.default_rng(seed)
    prompts = [r.integers(1, TINY["vocab_size"], n).tolist() for n in (5, 100, 45)]
    want, _ = _run_staggered(_jax_engine(jargs, jparams, **CHUNKED), prompts,
                             JSamplingParams)
    got, kinds = _run_staggered(_port_engine(targs, tparams, **CHUNKED), prompts,
                                SamplingParams)
    assert len(want) == 3 and got == want
    # 100 tokens in four chunks, 45 in two, every one riding with "s"
    assert kinds[:6] == ["mixed"] * 6 and set(kinds[6:]) == {"decode"}


STREAM_CONFIGS = {
    "w4a8kv4-g128-w8head": dict(precision="w4a8kv4", group_size=128, lm_head_bits=8),
    "w4a8kv8-g128": dict(precision="w4a8kv8", group_size=128),
    "w8a8kv8": dict(precision="w8a8kv8"),
    "w16a16kv8": dict(precision="w16a16kv8"),
}
_stream_pairs = {}


def _stream_pair(name):
    if name not in _stream_pairs:
        _stream_pairs[name] = tiny_pair(**STREAM_CONFIGS[name])
    return _stream_pairs[name]


@pytest.mark.parametrize("mode,seed", [("whole", 1), ("chunked", 1), ("chunked", 3)])
@pytest.mark.parametrize("name", sorted(STREAM_CONFIGS))
def test_precision_greedy_streams_match_jax_engine(name, mode, seed):
    """The other precisions against the JAX engine, whole-prompt prefill and
    chunked with mixed steps: identical greedy streams on these pinned prompt
    seeds. As at W4A8KV4 per-channel, other seeds (0 and 2 here) can break on
    a near-tie of this flat tiny model's logits: the f32 sums of the two
    sides land an ulp apart, a bf16 value moves to its neighbour, and logits
    closer than ~1e-2 swap (test_torch_llama bounds the logits)."""
    jargs, jparams, targs, tparams = _stream_pair(name)
    if mode == "whole":
        prompts = _prompts(4, seed=seed)
        kw = dict(max_tokens=8, temperature=0.0)
        want = _run(_jax_engine(jargs, jparams), prompts, JSamplingParams, **kw)
        got = _run(_port_engine(targs, tparams), prompts, SamplingParams, **kw)
        assert len(want) == 4
    else:
        r = np.random.default_rng(seed)
        prompts = [r.integers(1, TINY["vocab_size"], n).tolist() for n in (5, 100, 45)]
        want, _ = _run_staggered(_jax_engine(jargs, jparams, **CHUNKED), prompts,
                                 JSamplingParams)
        got, kinds = _run_staggered(_port_engine(targs, tparams, **CHUNKED), prompts,
                                    SamplingParams)
        assert len(want) == 3 and kinds[:6] == ["mixed"] * 6
    assert got == want


def test_long_prompt_chunked_matches_unchunked(pair):
    """The port against itself: a 150-token prompt in 64-token chunks gives
    the greedy stream of an engine whose budget takes it whole, and every
    page comes back."""
    _, _, targs, tparams = pair
    prompt = [(7 * i + 3) % 128 for i in range(150)]
    kw = dict(max_tokens=8, temperature=0.0)
    whole = _run(_port_engine(targs, tparams, max_num_batched_tokens=512,
                              enable_chunked_prefill=True),
                 [prompt], SamplingParams, **kw)
    small = _port_engine(targs, tparams, max_num_batched_tokens=64,
                         enable_chunked_prefill=True)
    assert _run(small, [prompt], SamplingParams, **kw) == whole
    assert small.scheduler.block_manager.get_num_free_device_pages() == 64


def test_decodes_ride_along_with_chunk_steps(pair):
    """While a long prompt admits over several chunk steps, a running
    sequence gains a token in EVERY step (mixed chunk+decode)."""
    _, _, targs, tparams = pair
    engine = _port_engine(targs, tparams, max_num_batched_tokens=64,
                          enable_chunked_prefill=True)
    kw = dict(temperature=0.0, ignore_eos=True)
    engine.add_request("run", prompt_token_ids=[3, 1, 4],
                       sampling_params=SamplingParams(max_tokens=40, **kw))
    engine.step()
    assert engine.last_step_kind == "prefill"
    _, run_seq = engine._seq_index[0]
    engine.add_request("long", prompt_token_ids=[(i * 5 + 1) % 128 for i in range(150)],
                       sampling_params=SamplingParams(max_tokens=4, **kw))
    chunk_steps, outputs, steps = 0, {}, 0
    while engine.has_unfinished_requests() and steps < 100:
        before = run_seq.get_output_len()
        admitting = bool(engine.scheduler.waiting)
        for out in engine.step():
            if out.finished:
                outputs[out.request_id] = out.outputs[0]["token_ids"]
        steps += 1
        if admitting:
            chunk_steps += 1
            assert engine.last_step_kind == "mixed"
            assert run_seq.get_output_len() == before + 1, \
                f"decode stalled during chunk step {steps}"
    assert chunk_steps == 3  # 150 tokens at 64 a step
    assert len(outputs["run"]) == 40 and len(outputs["long"]) == 4
    assert engine.scheduler.block_manager.get_num_free_device_pages() == 64


def test_decode_table_is_as_wide_as_the_longest_history(pair, monkeypatch):
    """The decode and mixed steps hand K4 a block table as wide as the
    batch's longest history, not max_model_len's (K4 sizes its split of
    each history by that width), and still serve the same tokens."""
    from qserve_tpu_torch.models import llama as tllama

    _, _, targs, tparams = pair
    seen = []

    def spy(fn, table_at, ctx_at):
        def wrapped(*a, **kw):
            seen.append((a[table_at].shape[1], int(a[ctx_at].max())))
            return fn(*a, **kw)
        return wrapped

    prompts = _prompts(3, seed=4) + [list(range(1, 70))]
    kw = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
    sched = dict(max_num_batched_tokens=32, enable_chunked_prefill=True)
    want = _run(_port_engine(targs, tparams, **sched), prompts, SamplingParams, **kw)
    monkeypatch.setattr(tllama, "decode", spy(tllama.decode, 3, 4))
    monkeypatch.setattr(tllama, "prefill_chunk_with_decode",
                        spy(tllama.prefill_chunk_with_decode, 11, 12))
    engine = _port_engine(targs, tparams, max_model_len=1024, **sched)
    assert engine.worker.model_runner.max_pages_per_seq == 1024 // BS
    assert _run(engine, prompts, SamplingParams, **kw) == want
    assert len(seen) > 6
    for width, longest in seen:
        assert width == -(-longest // BS), (width, longest)


def test_prefix_pos_compute_skip(pair):
    """A second request sharing a computed prefix is served by a chunk step
    that starts at the prefix's end: the prefix is marked computed, fewer
    prompt tokens are computed, and the stream is the JAX engine's."""
    jargs, jparams, targs, tparams = pair
    prefix = [(3 * i + 5) % 128 for i in range(64)]  # 4 pages of 16
    p1, p2 = prefix + [1, 2, 3], prefix + [4, 5, 6]

    def serve(engine, sp_cls):
        kw = dict(max_tokens=6, temperature=0.0)
        engine.add_request("r1", prompt_token_ids=p1, sampling_params=sp_cls(**kw),
                           prefix_pos=64)
        while engine.has_unfinished_requests():
            engine.step()
        before = engine._num_prompt_tokens
        engine.add_request("r2", prompt_token_ids=p2, sampling_params=sp_cls(**kw),
                           prefix_pos=64)
        group = engine.scheduler.waiting[0]
        kinds, toks = [], None
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished:
                    toks = out.outputs[0]["token_ids"]
            kinds.append(getattr(engine, "last_step_kind", None))
        return toks, engine._num_prompt_tokens - before, group, kinds

    want, jcomputed, _, _ = serve(_jax_engine(jargs, jparams, enable_chunked_prefill=True),
                                 JSamplingParams)
    got, computed, group, kinds = serve(_port_engine(targs, tparams,
                                                     enable_chunked_prefill=True),
                                        SamplingParams)
    assert group.prefix.computed and group.prefix.length == 64
    assert computed == jcomputed == 3  # only the suffix was prefilled
    assert kinds[0] == "chunk"
    assert len(got) == 6 and got == want


def test_n2_on_chunked_prompt(pair):
    """n=2 on a prompt longer than the budget: the final chunk's logits feed
    the extra candidate; both greedy candidates match the n=1 stream."""
    _, _, targs, tparams = pair
    prompt = [(11 * i + 2) % 128 for i in range(100)]
    sched = dict(max_num_batched_tokens=64, enable_chunked_prefill=True)
    ref = _run(_port_engine(targs, tparams, **sched), [prompt], SamplingParams,
               max_tokens=6, temperature=0.0)["r0"]
    dual = _port_engine(targs, tparams, **sched)
    dual.add_request("d", prompt_token_ids=prompt,
                     sampling_params=SamplingParams(n=2, max_tokens=6, temperature=0.0))
    done = None
    while dual.has_unfinished_requests():
        for out in dual.step():
            if out.finished:
                done = out
    assert len(done.outputs) == 2
    assert all(c["token_ids"] == ref for c in done.outputs)
    assert dual.scheduler.block_manager.get_num_free_device_pages() == 64


def test_prefix_continuation_step_served(pair):
    """A prefill step whose chunk starts past 0 goes through the chunk path
    of the worker: the cached first page is attended, not recomputed, and
    the sampled token is the whole-prompt prefill's."""
    _, _, targs, tparams = pair
    ids = list(range(1, 40))
    sp = SamplingParams(max_tokens=2, temperature=0.0)
    whole = _port_engine(targs, tparams)
    whole.add_request("r", prompt_token_ids=ids, sampling_params=sp)
    md, sched = whole.scheduler.schedule()
    (want,) = whole.worker.execute_model(md, sched)

    engine = _port_engine(targs, tparams)
    engine.add_request("r", prompt_token_ids=ids, sampling_params=sp)
    md, sched = engine.scheduler.schedule()
    md[0].chunk = (0, BS)  # first page alone, then the rest over it
    engine.worker.execute_model(md, sched)
    md[0].chunk = (BS, 39)
    (got,) = engine.worker.execute_model(md, sched)
    assert got == want


def test_benchmark_labels_steps_by_what_the_scheduler_emitted(pair, tmp_path):
    """With chunking on, a step is "mixed" when decode rows rode along with
    a chunk; the CSV gains the mixed column pair only in such a run."""
    from qserve_tpu_torch.entrypoints import benchmark

    _, _, targs, tparams = pair
    engine = _port_engine(targs, tparams, **CHUNKED)
    rows = benchmark.run(engine, TINY["vocab_size"], batch=2, prompt_len=40,
                         gen_len=6, rounds=1, csv_path=str(tmp_path / "m.csv"))
    # prompt 0: chunks (0, 32) and (32, 40); prompt 1 then admits beside it
    assert rows[0]["mixed_steps"] >= 2 and rows[0]["mixed_step_ms_mean"] > 0
    assert "mixed_steps" in (tmp_path / "m.csv").read_text().splitlines()[0]
    engine = _port_engine(targs, tparams)
    rows = benchmark.run(engine, TINY["vocab_size"], batch=2, prompt_len=40,
                         gen_len=6, rounds=1, csv_path=str(tmp_path / "p.csv"))
    assert "mixed_steps" not in rows[0]
    assert rows[0]["prefill_step_ms_mean"] > 0 and rows[0]["decode_step_ms_median"] > 0


@pytest.mark.parametrize("kw", [
    dict(data_parallel_size=2),
    dict(run_vlm=True, omit_vision_tower=True),
    dict(run_vlm=True, tensor_parallel_size=2),
])
def test_engine_args_refuse_unported(kw):
    args = dict(hf_config=_hf_config(), random_weights=True, device="cpu",
                num_device_pages=16, block_size=BS, max_model_len=128)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineArgs(**dict(args, **kw)).build_engine()


def _hf_config():
    return dict(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden_size"],
        intermediate_size=TINY["intermediate_size"],
        num_hidden_layers=TINY["num_layers"],
        num_attention_heads=TINY["num_heads"],
        num_key_value_heads=TINY["num_kv_heads"], rope_theta=500000.0,
    )


@pytest.mark.parametrize("group_size,quant_lm_head", [(-1, False), (128, True)])
@pytest.mark.parametrize("precision", [
    "w4a8kv4", "w4a8kv8", "w4a8", "w8a8kv4", "w8a8kv8", "w8a8",
    "w16a16kv4", "w16a16kv8", "w16a16"])
def test_engine_args_serve_every_precision(precision, group_size, quant_lm_head):
    """EngineArgs builds and serves the dense Llama at every precision
    string, per-channel or g128, bf16 or W8 lm_head, through a prefill, a
    chunked prompt riding with a decode, and decode steps."""
    from qserve_tpu_torch.layers import linear as tlin

    engine = EngineArgs(
        hf_config=_hf_config(), random_weights=True, device="cpu",
        precision=precision, group_size=group_size, quant_lm_head=quant_lm_head,
        num_device_pages=32, block_size=BS, max_model_len=128,
        max_num_batched_tokens=32, max_num_seqs=4,
    ).build_engine()
    runner = engine.worker.model_runner
    q = runner.model_args.quant
    flavor = {16: tlin.W16Linear, 8: tlin.W8Linear}.get(
        q.weight_bits, tlin.W4ChnLinear if group_size == -1 else tlin.W4GrpLinear)
    assert type(runner.params.layers.qkv) is flavor
    assert isinstance(runner.params.lm_head, tlin.W8Linear) == quant_lm_head
    kv8 = not precision.endswith("kv4")
    assert engine.worker.cache_engine.cache.data.shape[-1] == (
        TINY["num_kv_heads"] * TINY["head_dim"] // (1 if kv8 else 2))
    outs, kinds = _run_staggered(
        engine, [[1, 2, 3], list(range(1, 51))], SamplingParams)
    assert len(outs["s"]) == 20 and len(outs["r0"]) == 8
    assert "mixed" in kinds and "decode" in kinds


def test_engine_args_build_and_benchmark_entry_point(tmp_path):
    """EngineArgs -> engine from a config dict with random weights, driven
    by the port's benchmark entry point."""
    from qserve_tpu_torch.entrypoints import benchmark

    engine = EngineArgs(
        hf_config=_hf_config(), random_weights=True, device="cpu",
        num_device_pages=32, block_size=BS, max_model_len=128,
        max_num_batched_tokens=128, max_num_seqs=4,
    ).build_engine()
    sc = engine.scheduler.scheduler_config  # the scheduler's own defaults
    assert sc.enable_chunked_prefill is True and sc.mixed_chunk_decode is True
    rows = benchmark.run(engine, TINY["vocab_size"], batch=3, prompt_len=20,
                         gen_len=4, rounds=1, csv_path=str(tmp_path / "r.csv"))
    assert rows[0]["batch"] == 3 and rows[0]["tokens_per_s"] > 0
    assert (rows[0]["precision"], rows[0]["group_size"], rows[0]["lm_head_bits"]) \
        == ("w4a8kv4", -1, 16)
    assert (tmp_path / "r.csv").exists()


def test_engine_args_default_to_cuda():
    if torch.cuda.is_available():
        assert EngineArgs().device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            EngineArgs(hf_config=_hf_config(), random_weights=True,
                       num_device_pages=16).build_engine()


def test_cli_takes_the_jax_packages_flags(tmp_path):
    """The JAX benchmark's documented command line (and every flag of
    qserve_tpu's EngineArgs) parses on the port's benchmark parser and
    builds a device-fed engine; the flags without meaning here are accepted
    and left at their values."""
    import argparse
    import json

    from qserve_tpu.engine.arg_utils import EngineArgs as JEngineArgs
    from qserve_tpu_torch.entrypoints import benchmark

    with open(tmp_path / "config.json", "w") as f:
        json.dump(_hf_config(), f)
    argv = ["--model", str(tmp_path), "--random-weights", "--precision", "w4a8kv4",
            "--benchmarking", "--device", "cpu", "--num-device-pages", "16",
            "--block-size", str(BS), "--max-model-len", "128"]
    a = benchmark.add_args(argparse.ArgumentParser()).parse_args(argv)
    ea = EngineArgs.from_cli_args(a)
    assert ea.model == str(tmp_path) and ea.random_weights and ea.benchmarking
    engine = ea.build_engine()
    assert engine.worker.model_runner.benchmarking and engine.tokenizer is None
    # every option string of the JAX parser is one of the port's
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    JEngineArgs.add_cli_args(jp)
    EngineArgs.add_cli_args(tp)
    jopts = {o for act in jp._actions for o in act.option_strings}
    topts = {o for act in tp._actions for o in act.option_strings}
    assert jopts <= topts, sorted(jopts - topts)
    ignored = ["--model", "m", "--no-ifb-mode", "--no-scan-layers",
               "--profiling-prompt-len", "8", "--profiling-generation-len", "4",
               "-pp", "2", "--trust-remote-code"]
    ea = EngineArgs.from_cli_args(tp.parse_args(ignored))
    ea.random_weights = True  # the ignored flags alone refuse nothing
    ea._refuse_unported()
    assert not ea.ifb_mode and not ea.scan_layers and ea.pipeline_parallel_size == 2


def test_num_gpu_page_blocks_env(monkeypatch):
    """NUM_GPU_PAGE_BLOCKS sets the page count unless --num-device-pages is
    given, as in qserve_tpu."""
    monkeypatch.setenv("NUM_GPU_PAGE_BLOCKS", "37")
    cache_config, _ = EngineArgs().create_engine_configs()
    assert cache_config.num_device_pages == 37
    cache_config, _ = EngineArgs(num_device_pages=12).create_engine_configs()
    assert cache_config.num_device_pages == 12
    monkeypatch.delenv("NUM_GPU_PAGE_BLOCKS")
    assert EngineArgs().create_engine_configs()[0].num_device_pages is None
