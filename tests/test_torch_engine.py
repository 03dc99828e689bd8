"""Port parity at the engine: the JAX package's LLMEngine and the port's,
on the same tiny quantized params, give identical greedy token streams.
Also the port's refusals: what this slice does not carry raises
NotImplementedError naming its ROADMAP item."""

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
    threshold_mask); only CUDA refuses the filtered sampler."""
    _, _, targs, tparams = pair
    outs = _run(_port_engine(targs, tparams), _prompts(2, seed=1), SamplingParams,
                max_tokens=5, temperature=0.8, top_k=5, top_p=0.9)
    assert all(len(t) == 5 for t in outs.values())
    outs = _run(_port_engine(targs, tparams), _prompts(2, seed=2), SamplingParams,
                max_tokens=5, temperature=0.8)
    assert all(len(t) == 5 for t in outs.values())


def test_chunked_prefill_step_refused(pair):
    """A prompt longer than the token budget is chunked by the scheduler
    when chunked prefill is on; the port refuses the chunk step."""
    _, _, targs, tparams = pair
    engine = _port_engine(targs, tparams, max_num_batched_tokens=32,
                          enable_chunked_prefill=True)
    engine.add_request("long", prompt_token_ids=list(range(1, 60)),
                       sampling_params=SamplingParams(max_tokens=2))
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        engine.step()


def test_prefix_continuation_step_refused(pair):
    """A prefill step whose chunk starts past 0 (a cached prefix) raises."""
    _, _, targs, tparams = pair
    engine = _port_engine(targs, tparams)
    engine.add_request("r", prompt_token_ids=list(range(1, 40)),
                       sampling_params=SamplingParams(max_tokens=2))
    md, sched = engine.scheduler.schedule()
    md[0].chunk = (BS, 39)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.worker.execute_model(md, sched)


@pytest.mark.parametrize("kw", [
    dict(run_vlm=True),
    dict(tensor_parallel_size=2),
    dict(data_parallel_size=2),
    dict(random_weights=False),
    dict(precision="w8a8kv4"),
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


def test_engine_args_build_and_benchmark_entry_point(tmp_path):
    """EngineArgs -> engine from a config dict with random weights, driven
    by the port's benchmark entry point."""
    from qserve_tpu_torch.entrypoints import benchmark

    engine = EngineArgs(
        hf_config=_hf_config(), random_weights=True, device="cpu",
        num_device_pages=32, block_size=BS, max_model_len=128,
        max_num_batched_tokens=128, max_num_seqs=4,
    ).build_engine()
    assert engine.scheduler.scheduler_config.enable_chunked_prefill is False
    rows = benchmark.run(engine, TINY["vocab_size"], batch=3, prompt_len=20,
                         gen_len=4, rounds=1, csv_path=str(tmp_path / "r.csv"))
    assert rows[0]["batch"] == 3 and rows[0]["tokens_per_s"] > 0
    assert (tmp_path / "r.csv").exists()


def test_engine_args_default_to_cuda():
    if torch.cuda.is_available():
        assert EngineArgs().device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            EngineArgs(hf_config=_hf_config(), random_weights=True,
                       num_device_pages=16).build_engine()
