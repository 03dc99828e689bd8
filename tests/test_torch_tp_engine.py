"""Port parity of tensor parallelism across processes: each port rank is a
spawned process on the CPU (gloo), the JAX side runs in this process on the
virtual CPU devices of tests/conftest.py, on the same numpy float weights.

  * tp = 2 prefill and decode logits against the JAX package's step
    functions at tp = 2 (shard_map over a (dp 1, tp 2) mesh, the bodies of
    parallel/tp.py build_step_fns without the sampler) within ATOL = 1e-2,
    the tolerance tests/test_torch_llama.py holds at tp = 1 on weights of
    the same scale (N(0, 0.02): |logits| ~0.3): W16A16KV8,
    W4A8KV4, W8A8KV8 and a small Mixtral; W16A16KV8 also at tp = 4. The
    ranks' logits are equal bit for bit;
  * greedy engine streams at tp = 2 equal the JAX Worker.create_tp engine's
    at W4A8KV4 and W8A8KV8, on prompt sets pinned away from near-ties
    (ROADMAP queue 3), and the two ranks' streams are equal;
  * tests/test_tp_engine.py's robustness cases (abort, recompute and swap
    preemption, chunked against unchunked, decodes riding with chunks,
    n = 2 greedy);
  * a bf16 all_reduce of two gloo ranks is the f32 sum rounded once (so o
    and down reduce in bf16, as parallel/tp.py does);
  * EngineArgs(model=<float HF directory>, tensor_parallel_size=2), each
    rank quantizing its shards of the checkpoint (quant_path ignored),
    serves the streams Worker.create_tp gives on the same float weights;
  * the benchmark entry point at -tp 2, as torchrun runs it: rank 0 alone
    prints and writes the CSV row, which names tp;
  * dryrun_multichip(4): dp 2 x tp 2;
  * build_engine at tp = 2 without a process group raises.

The port's spawns start when the module starts so that they run beside
the JAX side: the two tp = 2 ranks (every tp = 2 case in one spawn) at
once with the four-rank spawns, which run one after the other. Each spawn
has its own deadline."""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from qserve_tpu.config import CacheConfig as JCacheConfig
from qserve_tpu.config import QuantSpec as JQuantSpec
from qserve_tpu.config import SchedulerConfig as JSchedulerConfig
from qserve_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu.models import llama as jllama
from qserve_tpu.models import mixtral as jmixtral
from qserve_tpu.parallel import tp as jtp
from qserve_tpu.sampling_params import SamplingParams as JSamplingParams
from qserve_tpu.worker.worker import Worker as JWorker
from qserve_tpu_torch.engine.arg_utils import EngineArgs
from qserve_tpu_torch.models import llama as tllama
from qserve_tpu_torch.parallel import distributed, dryrun

ATOL = 1e-2
PS, PAGES = 16, 16
GEO = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=32)
LOGIT_CASES = {
    "w16a16kv8": dict(GEO),
    "w4a8kv4": dict(GEO),
    "w8a8kv8": dict(GEO),
    # tests/test_mixtral.py's tiny MoE geometry, as tests/test_torch_mixtral.py
    "mixtral_w4a8kv4": dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                            num_experts=4, moe_top_k=2),
}
TP4 = dict(GEO, num_kv_heads=4)
# the engine streams: tests/test_tp_engine.py's geometry, prompt sets
# pinned where the two packages' greedy streams agree
ENGINE_SEED = {"w4a8kv4": 0, "w8a8kv8": 0}
SCHED = dict(max_num_batched_tokens=64, max_num_seqs=4, max_model_len=96)
ROBUST = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16)


def _quant_fields(precision):
    q = JQuantSpec.from_precision(precision)
    return dict(weight_bits=q.weight_bits, act_bits=q.act_bits, kv_bits=q.kv_bits)


def _jargs(precision, tp, geo):
    return jllama.LlamaArgs(quant=JQuantSpec.from_precision(precision), tp_size=tp, **geo)


def _float_np(precision, geo, seed=0):
    args = _jargs(precision, 1, geo)
    build = jmixtral if geo.get("num_experts") else jllama
    return jax.tree.map(np.asarray, build.random_float_params(jax.random.PRNGKey(seed), args))


def _inputs(V):
    """Two prompts (21 and 10 tokens) packed into 32 rows with a pad row,
    then one decode step of both."""
    r = np.random.default_rng(0)
    T, lens, tables = 32, [21, 10], [[0, 1], [2]]
    tok, pos, seg = (np.zeros(T, np.int32) for _ in range(3))
    pages, slots = np.full(T, -1, np.int32), np.zeros(T, np.int32)
    t, last = 0, []
    for i, n in enumerate(lens):
        tok[t:t + n] = r.integers(1, V, n)
        pos[t:t + n] = np.arange(n)
        seg[t:t + n] = i + 1
        pages[t:t + n] = [tables[i][p // PS] for p in range(n)]
        slots[t:t + n] = np.arange(n) % PS
        t += n
        last.append(t - 1)
    prefill = (tok, pos, seg, pages, slots, np.array(last, np.int32))
    decode = (np.array([17, 5], np.int32), np.array([[0, 1], [2, 0]], np.int32),
              np.array([22, 11], np.int32))
    return prefill, decode


def _logit_case(name, precision, geo):
    prefill, decode = _inputs(geo["vocab_size"])
    return dict(name=name, args=dict(geo, quant=_quant_fields(precision)),
                fp=_float_np(precision, geo),
                prefill=prefill, decode=decode,
                pages=PAGES, page_size=PS)


def _engine_requests(seed, V=256):
    r = np.random.default_rng(seed)
    return [dict(id=f"r{i}", prompt=r.integers(1, V, int(n)).tolist(),
                 sp=dict(max_tokens=8, temperature=0.0, ignore_eos=True))
            for i, n in enumerate(r.integers(5, 40, 3))]


def _serve_spec(precision):
    return dict(args=dict(GEO, quant=_quant_fields(precision)),
                fp=_float_np(precision, GEO), cache=dict(block_size=PS, num_device_pages=64),
                sched=SCHED, requests=_engine_requests(ENGINE_SEED[precision]))


# the benchmark entry point as `torchrun --nproc-per-node 2 -m
# qserve_tpu_torch.entrypoints.benchmark` runs it, on HF_CFG's random weights
BENCH_ARGV = ["-tp", "2", "--random-weights", "--device", "cpu", "--block-size", "16",
              "--num-device-pages", "16", "--max-model-len", "64",
              "--max-num-batched-tokens", "64", "--prompt-len", "16",
              "--generation-len", "4", "--global-batch-size", "2", "--rounds", "1"]
HF_CFG = dict(architectures=["LlamaForCausalLM"], vocab_size=256, hidden_size=128,
              intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6)


def _hf_specs(d):
    """A float HF directory of HF_CFG's widths in d, and the two serve specs
    over it: EngineArgs(model=d) and Worker.create_tp over the same float
    weights as loaded by the port's loader."""
    import json
    import os

    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.models import loader
    from qserve_tpu_torch.utils import weight_utils as wu

    r = np.random.default_rng(4)
    E, I, V, L = 128, 256, 256, 2
    state = {"model.embed_tokens.weight": r.standard_normal((V, E)),
             "model.norm.weight": 1 + 0.1 * r.standard_normal(E),
             "lm_head.weight": r.standard_normal((V, E))}
    for li in range(L):
        p = f"model.layers.{li}"
        state.update({f"{p}.input_layernorm.weight": 1 + 0.1 * r.standard_normal(E),
                      f"{p}.post_attention_layernorm.weight": 1 + 0.1 * r.standard_normal(E),
                      f"{p}.self_attn.q_proj.weight": r.standard_normal((E, E)),
                      f"{p}.self_attn.k_proj.weight": r.standard_normal((E // 2, E)),
                      f"{p}.self_attn.v_proj.weight": r.standard_normal((E // 2, E)),
                      f"{p}.self_attn.o_proj.weight": r.standard_normal((E, E)),
                      f"{p}.mlp.gate_proj.weight": r.standard_normal((I, E)),
                      f"{p}.mlp.up_proj.weight": r.standard_normal((I, E)),
                      f"{p}.mlp.down_proj.weight": r.standard_normal((E, I))})
    scale = {k: 1.0 if "norm" in k else 0.02 for k in state}
    state = {k: torch.from_numpy((v * scale[k]).astype(np.float32)) for k, v in state.items()}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF_CFG, f)
    wu.write_safetensors(state, os.path.join(d, "model.safetensors"))
    args = tllama.LlamaArgs.from_config_dict(HF_CFG, QuantSpec.from_precision("w4a8kv4"))
    fp = loader.load_float_params_from_hf(str(d), args)
    fp = {k: ([{n: x.numpy() for n, x in layer.items()} for layer in v] if k == "layers"
              else v.numpy()) for k, v in fp.items()}
    requests = _engine_requests(1)
    engine = dict(model=str(d), tokenizer=os.path.join(d, "no-tokenizer"), quant_path=str(d),
                  precision="w4a8kv4", block_size=PS, num_device_pages=64, seed=0, **SCHED)
    worker = dict(args=dict(GEO, quant=_quant_fields("w4a8kv4")), fp=fp,
                  cache=dict(block_size=PS, num_device_pages=64), sched=SCHED)
    return dict(engine_args=engine, requests=requests), dict(worker, requests=requests)


@pytest.fixture(scope="module", autouse=True)
def port(tmp_path_factory):
    """Start the port's spawns beside the JAX side of the tests: the two
    tp = 2 ranks at once with the four-rank runs, which go one after the
    other (at most six ranks at a time); each test waits for the result it
    reads."""
    hf = tmp_path_factory.mktemp("hf")
    robust_fp = tllama.random_float_params(
        0, tllama.LlamaArgs(**ROBUST), scale=0.05)
    robust = dict(args=dict(ROBUST, quant=_quant_fields("w8a8kv8")),
                  fp={k: (v.numpy() if isinstance(v, torch.Tensor)
                          else [{n: x.numpy() for n, x in layer.items()} for layer in v])
                      for k, v in robust_fp.items()})
    tp2_jobs = [
        (dryrun.reduce_check_rank, ()),
        (dryrun.logits_rank, ([_logit_case(n, n.replace("mixtral_", ""), g)
                               for n, g in LOGIT_CASES.items()],)),
        (dryrun.serve_rank, (_serve_spec("w4a8kv4"),)),
        (dryrun.serve_rank, (_serve_spec("w8a8kv8"),)),
        (dryrun.robustness_rank, (robust,)),
    ] + [(dryrun.serve_rank, (spec,)) for spec in _hf_specs(hf)] + [
        (dryrun.benchmark_rank, (BENCH_ARGV + ["--model", str(hf), "--results-csv",
                                               str(hf / "bench.csv")],))]
    pair, four = cf.ThreadPoolExecutor(1), cf.ThreadPoolExecutor(1)
    futures = dict(
        tp2=pair.submit(distributed.spawn, dryrun.jobs_rank, 2, (tp2_jobs,), 150),
        tp4=four.submit(distributed.spawn, dryrun.logits_rank, 4,
                        ([_logit_case("w16a16kv8", "w16a16kv8", TP4)],), 150),
        dryrun=four.submit(dryrun.dryrun_multichip, 4, 150),
    )
    yield dict(futures, hf=hf)
    pair.shutdown(wait=True)
    four.shutdown(wait=True)


def _tp2(port):
    reduce, logits, serve_w4, serve_w8, robust, hf_engine, hf_worker, bench = zip(
        *port["tp2"].result(timeout=200))
    return dict(reduce=reduce, logits=logits, serve={"w4a8kv4": serve_w4, "w8a8kv8": serve_w8},
                robust=robust, hf=(hf_engine, hf_worker), bench=bench)


def _jax_logits(precision, geo, tp):
    """The JAX package at tp: prefill and decode logits under shard_map
    over a (dp 1, tp) mesh, from the same float weights."""
    jargs = _jargs(precision, tp, geo)
    fp = jax.tree.map(jnp.asarray, _float_np(precision, geo))
    mesh = jtp.make_mesh(1, tp)
    params, specs = jtp.quantize_params_tp(fp, jargs)
    params = jtp.shard_params(params, specs, mesh)
    cache = jtp.shard_kv_cache(jkvc.create_kv_cache(
        jargs.num_layers, PAGES, jargs.num_kv_heads, PS, jargs.head_dim,
        jargs.quant.kv_bits), mesh)
    kv_specs, dpv = jtp.kv_cache_specs(), P(jtp.DP)
    prefill = jax.jit(jtp._shard_map(
        lambda p, kv, *x: jllama.prefill(p, kv, *x, jargs), mesh,
        in_specs=(specs, kv_specs) + (dpv,) * 6, out_specs=(dpv, kv_specs)))
    decode = jax.jit(jtp._shard_map(
        lambda p, kv, *x: jllama.decode(p, kv, *x, jargs), mesh,
        in_specs=(specs, kv_specs, dpv, P(jtp.DP, None), dpv), out_specs=(dpv, kv_specs)))
    pre_in, dec_in = _inputs(geo["vocab_size"])
    pre, cache = prefill(params, cache, *map(jnp.asarray, pre_in))
    dec, _ = decode(params, cache, *map(jnp.asarray, dec_in))
    return np.asarray(pre, np.float32), np.asarray(dec, np.float32)


def _hold(ranks, name, want_pre, want_dec):
    for r, out in enumerate(ranks):
        got = out[name]
        np.testing.assert_allclose(got["prefill"], want_pre, atol=ATOL,
                                   err_msg=f"{name} rank {r} prefill")
        np.testing.assert_allclose(got["decode"], want_dec, atol=ATOL,
                                   err_msg=f"{name} rank {r} decode")
        np.testing.assert_array_equal(got["prefill"], ranks[0][name]["prefill"])
        np.testing.assert_array_equal(got["decode"], ranks[0][name]["decode"])


@pytest.mark.parametrize("name", list(LOGIT_CASES))
def test_tp2_logits_match_jax_tp2(port, name):
    want = _jax_logits(name.replace("mixtral_", ""), LOGIT_CASES[name], 2)
    _hold(_tp2(port)["logits"], name, *want)


def test_tp4_w16a16_logits_match_jax_tp4(port):
    want = _jax_logits("w16a16kv8", TP4, 4)
    _hold(port["tp4"].result(timeout=200), "w16a16kv8", *want)


@pytest.mark.parametrize("precision", list(ENGINE_SEED))
def test_tp2_engine_greedy_streams_match_jax_engine(port, precision):
    spec = _serve_spec(precision)
    jargs = _jargs(precision, 1, GEO)
    cc = JCacheConfig(block_size=PS, num_device_pages=64, quant=jargs.quant)
    sc = JSchedulerConfig(**SCHED)
    engine = JLLMEngine(JWorker.create_tp(jax.tree.map(jnp.asarray, spec["fp"]), jargs, cc,
                                          sc, tp_size=2), sc, cc)
    for r in spec["requests"]:
        engine.add_request(r["id"], prompt_token_ids=r["prompt"],
                           sampling_params=JSamplingParams(**r["sp"]))
    want = {}
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                want[out.request_id] = [list(o["token_ids"]) for o in out.outputs]
    ranks = _tp2(port)["serve"][precision]
    for r, out in enumerate(ranks):
        assert out["streams"] == want, f"rank {r}"
        assert out["backend"] == "gloo" and out["tp_rank"] == r
        # every step's collectives: 2 all_reduces a layer, 1 all_gather
        for step in out["log"]:
            assert step["collectives"] == {"all_reduce": 2 * GEO["num_layers"],
                                           "all_gather": 1}, step
    assert ranks[0]["streams"] == ranks[1]["streams"]
    assert ranks[0]["cache_shape"][0][-1] == GEO["num_kv_heads"] // 2 * GEO["head_dim"] // (
        2 if precision.endswith("kv4") else 1)


def test_tp2_robustness(port):
    """tests/test_tp_engine.py's cases, on each rank; the ranks agree."""
    ranks = _tp2(port)["robust"]
    for res in ranks:
        assert res["abort"] == dict(done=["b"], free=32)
        assert res["recompute"]["lens"] == {"r0": 34, "r1": 34, "r2": 34}
        assert res["recompute"]["free"] == 7
        assert res["swap"]["swapped"] and res["swap"]["lens"] == {"s0": 8}
        ch = res["chunked"]
        assert ch["chunked"] == ch["whole"] and ch["free"] == 32
        ride = res["ride_along"]
        assert ride["chunk_steps"] >= 1 and ride["stalled"] == 0
        assert ride["lens"] == {"run": 16, "long": 4} and ride["free"] == 32
        for name in ("n2", "n2_chunked"):
            assert res[name]["got"] == [res[name]["want"]] * 2 and res[name]["free"] == 32
    assert ranks[0] == ranks[1]


def test_tp2_engine_args_serve_a_float_hf_directory(port):
    """Each rank loads the float checkpoint and quantizes its own shards;
    the streams equal Worker.create_tp's on the same float weights, rank by
    rank, and the ranks agree."""
    engine, worker = _tp2(port)["hf"]
    for r in range(2):
        assert engine[r]["streams"] == worker[r]["streams"], f"rank {r}"
        assert len(engine[r]["streams"]) == 3
    assert engine[0]["streams"] == engine[1]["streams"]


def test_benchmark_entry_point_at_tp2_rank0_prints_and_writes(port):
    """Both ranks ran the same requests; rank 0 alone printed its round and
    wrote the CSV row, which names tp and a decode that was not device-fed."""
    import csv

    bench = _tp2(port)["bench"]
    assert "round 0: 2 seqs, 8 tokens" in bench[0]["stdout"]
    assert bench[1]["stdout"] == ""
    csv_path = port["hf"] / "bench.csv"
    rows = list(csv.DictReader(open(csv_path)))
    assert len(rows) == 1
    assert rows[0]["tp"] == "2" and rows[0]["device_feed"] == "False"


def test_bf16_all_reduce_of_two_gloo_ranks_is_the_f32_sum_rounded_once(port):
    ranks = _tp2(port)["reduce"]
    want = (torch.from_numpy(ranks[0]["x"]) + torch.from_numpy(ranks[1]["x"])).to(
        torch.bfloat16).float().numpy()
    for r in ranks:
        assert r["dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(r["y"], want)


def test_dryrun_multichip_dp2_tp2(port):
    out = port["dryrun"].result(timeout=350)
    assert [(r["replica"], r["tp_rank"]) for r in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert out[0]["tokens"] == out[1]["tokens"] and out[2]["tokens"] == out[3]["tokens"]


def test_build_engine_at_tp2_without_a_process_group_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    ea = EngineArgs(hf_config=dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2),
                    random_weights=True, device="cpu", tensor_parallel_size=2,
                    num_device_pages=16, block_size=16, max_model_len=64)
    with pytest.raises(RuntimeError, match="torchrun"):
        ea.build_engine()
