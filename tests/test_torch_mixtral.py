"""Port parity: Mixtral's sparse-MoE layers (qserve_tpu_torch/models/mixtral.py
and the MoE parts of models/llama.py) against the JAX package's, at the JAX
suite's tiny MoE geometry (tests/test_mixtral.py: hidden 64, intermediate
96, 4 experts, top-2) and at hidden 256 / intermediate 512 where a 128-wide
group needs it.

The JAX package makes the float weights (mixtral.random_float_params) and
quantizes them; the port receives them through params_from_numpy. Routing is
discrete: a router logit an ulp apart can swap a token's 2nd and 3rd expert
and change its MoE output entirely, so the MLP tests pin inputs whose top-2
versus 3rd probability margin is above 1e-4 and assert the same experts
before comparing outputs. The model tests hold logits within atol 1e-2, as
the dense precisions are held (|logits| ~0.5 here), on pinned seeds; the
greedy streams are pinned seeds that agree (near-ties of this flat tiny
model's logits can swap otherwise, as for the dense model)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.config import CacheConfig as JCacheConfig
from qserve_tpu.config import QuantSpec as JQuantSpec
from qserve_tpu.config import SchedulerConfig as JSchedulerConfig
from qserve_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu.kernels import ops as jops
from qserve_tpu.models import llama as jllama
from qserve_tpu.models import mixtral as jmixtral
from qserve_tpu.sampling_params import SamplingParams as JSamplingParams
from qserve_tpu.worker.worker import Worker as JWorker
from qserve_tpu_torch.config import CacheConfig, QuantSpec, SchedulerConfig
from qserve_tpu_torch.convert.from_jax import params_from_numpy
from qserve_tpu_torch.engine.arg_utils import EngineArgs
from qserve_tpu_torch.engine.llm_engine import LLMEngine
from qserve_tpu_torch.kernels import kv_cache as tkvc
from qserve_tpu_torch.kernels import ops as tops
from qserve_tpu_torch.layers import linear as tlin
from qserve_tpu_torch.models import llama as tllama
from qserve_tpu_torch.models import mixtral as tmixtral
from qserve_tpu_torch.sampling_params import SamplingParams
from qserve_tpu_torch.worker.worker import Worker
from torch_port_util import to_np

# tests/test_mixtral.py's tiny MoE geometry
TINY = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, num_experts=4, moe_top_k=2,
)
WIDE = dict(TINY, hidden_size=256, intermediate_size=512, head_dim=64)
# Streams of 32 rows or more take the routed dispatch in 16-row blocks (the
# JAX suite's blocks; on the card the kernels take multiples of 64): the
# 32-token prefill and chunk and the 34-row mixed step route, decode runs
# the masked loop.
ROUTE = dict(moe_route_min_tokens=32, moe_route_block=16)
PS = 16
ATOL = 1e-2
CONFIGS = {
    "w4a8kv4": dict(precision="w4a8kv4", group_size=-1),
    "w4a8kv4-g32": dict(precision="w4a8kv4", group_size=32),
    "w4a8kv4-g128-wide": dict(precision="w4a8kv4", group_size=128, wide=True),
    "w8a8kv8": dict(precision="w8a8kv8", group_size=-1),
    "w16a16kv8": dict(precision="w16a16kv8", group_size=-1),
}
_pairs = {}


def moe_pair(name, **overrides):
    """(JAX args, JAX params, port args, port params, JAX float params);
    overrides change the args (dispatch thresholds), not the weights."""
    if name not in _pairs:
        cfg = CONFIGS[name]
        geo = WIDE if cfg.get("wide") else TINY
        spec = (cfg["precision"], cfg["group_size"])
        jargs = jllama.LlamaArgs(quant=JQuantSpec.from_precision(*spec), **geo)
        targs = tllama.LlamaArgs(quant=QuantSpec.from_precision(*spec), **geo)
        fp = jmixtral.random_float_params(jax.random.PRNGKey(0), jargs)
        jparams = jmixtral.quantize_params(fp, jargs)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        _pairs[name] = (jargs, jparams, targs, tparams, fp)
    jargs, jparams, targs, tparams, fp = _pairs[name]
    return (dataclasses.replace(jargs, **overrides), jparams,
            dataclasses.replace(targs, **overrides), tparams, fp)


def _gs(args):
    return args.quant.group_size if args.quant.group_size > 0 else 128


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_numpy_carries_moe_layers(name):
    """A `router` field makes MoE layers; the experts' linears cross as
    [L, NE, ...] in their flavor, bit for bit."""
    _, jparams, targs, tparams, _ = moe_pair(name)
    L, E, NE = targs.num_layers, targs.hidden_size, targs.num_experts
    layers = tparams.layers
    assert isinstance(layers, tllama.MoELayerParams)
    assert layers.router.shape == (L, E, NE) and layers.router.dtype == torch.float32
    for lname in ("gate_up", "down"):
        tp, jp = getattr(layers, lname), getattr(jparams.layers, lname)
        assert tp._fields == jp._fields
        assert all(t.shape[:2] == (L, NE) for t in tp)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(to_np(a), np.asarray(b, to_np(a).dtype))


@pytest.mark.parametrize("name", ["w4a8kv4", "w4a8kv4-g128-wide", "w8a8kv8", "w16a16kv8"])
def test_quantize_params_matches_jax(name):
    """The port's Mixtral quantizer, expert by expert into stacked tensors,
    gives the JAX package's params bit for bit from the same float dict."""
    jargs, jparams, targs, _, fp = moe_pair(name)
    tp = tmixtral.quantize_params(jax.tree.map(np.asarray, fp), targs, device="cpu")
    for lname in ("qkv", "o", "gate_up", "down"):
        for a, b in zip(getattr(tp.layers, lname), getattr(jparams.layers, lname)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b, to_np(a).dtype))
    np.testing.assert_array_equal(tp.layers.router.numpy(), np.asarray(jparams.layers.router))


def test_random_quantized_params_moe_shapes():
    args = tllama.LlamaArgs(quant=QuantSpec.from_precision("w4a8kv4", 128), **WIDE)
    p = tmixtral.random_quantized_params(0, args, device="cpu")
    L, E, I, NE = 2, 256, 512, 4
    assert isinstance(p.layers, tllama.MoELayerParams)
    assert type(p.layers.gate_up) is tlin.W4GrpLinear
    assert p.layers.gate_up.qweight.shape == (L, NE, E // 2, 2 * I)
    assert p.layers.down.s2_scale.shape == (L, NE, I // 128, E)
    assert p.layers.qkv.qweight.shape == (L, E // 2, args.qkv_out)
    again = tmixtral.random_quantized_params(0, args, device="cpu")
    assert torch.equal(p.layers.down.qweight, again.layers.down.qweight)


# ---------------------------------------------------------------------------
# the MoE MLP
# ---------------------------------------------------------------------------


def _routing(jargs, jparams, hj, tparams, xt, k):
    """Both sides' top-k experts of each token, and the JAX side's margin
    between the k-th and the (k+1)-th probability."""
    xj = jops.rmsnorm(hj, jparams.layers.post_ln[0], jargs.rms_eps)
    pj = jax.nn.softmax(
        jops.matmul(xj, jparams.layers.router[0].astype(jnp.bfloat16), jnp.float32), -1)
    pt = torch.softmax(tops.matmul(xt, tparams.layers.router[0].to(torch.bfloat16),
                                   torch.float32), -1)
    ps = np.sort(np.asarray(pj), -1)
    return (np.asarray(jax.lax.top_k(pj, k)[1]), torch.topk(pt, k)[1].numpy(),
            (ps[:, -k] - ps[:, -k - 1]).min())


@pytest.mark.parametrize("dispatch", ["masked", "routed"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_mlp_matches_jax(name, dispatch):
    """_moe_mlp of layer 0 on 64 pinned tokens: the same experts, then the
    same output within one bf16 step of the largest (the experts' outputs
    are bf16; the two softmaxes may put a routing weight an f32 ulp apart)."""
    kw = dict(moe_route_min_tokens=10**9) if dispatch == "masked" else ROUTE
    jargs, jparams, targs, tparams, _ = moe_pair(name, **kw)
    h = np.random.default_rng(0).standard_normal((64, targs.hidden_size))
    ht = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16)
    hj = jnp.asarray(to_np(ht)).astype(jnp.bfloat16)
    xt = tops.rmsnorm(ht, tparams.layers.post_ln[0], targs.rms_eps)
    ti_j, ti_t, margin = _routing(jargs, jparams, hj, tparams, xt, targs.moe_top_k)
    assert margin > 1e-4, margin
    np.testing.assert_array_equal(ti_t, ti_j)

    int8 = targs.quant.act_bits == 8
    want = np.asarray(jllama._moe_mlp(jparams.layers, hj, jargs, int8, _gs(jargs),
                                      li=jnp.int32(0), stacked=True))
    layers = tparams.layers
    got = tllama._moe_mlp(layers.router[0], layers.gate_up.layer(0),
                          layers.down.layer(0), xt, targs, int8, _gs(targs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0**-8 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_routed_dispatch_equals_masked_loop(name):
    """In the port the routed dispatch gives the masked loop's output bit
    for bit: each (token, expert) row sees the same integer sums and the
    same epilogue, and each token's two weighted rows are added once."""
    _, _, targs, tparams, _ = moe_pair(name)
    h = np.random.default_rng(1).standard_normal((80, targs.hidden_size))
    x = tops.rmsnorm(torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16),
                     tparams.layers.post_ln[1], targs.rms_eps)
    layers = tparams.layers
    int8 = targs.quant.act_bits == 8
    out = {}
    for mode, kw in (("masked", dict(moe_route_min_tokens=10**9)), ("routed", ROUTE)):
        out[mode] = tllama._moe_mlp(
            layers.router[1], layers.gate_up.layer(1), layers.down.layer(1), x,
            dataclasses.replace(targs, **kw), int8, _gs(targs))
    assert torch.equal(out["masked"], out["routed"])


def test_dispatch_by_stream_length(monkeypatch):
    """The routed dispatch serves streams of moe_route_min_tokens or more
    (prefill), the masked loop shorter ones (decode)."""
    _, _, targs, tparams, _ = moe_pair("w4a8kv4", **ROUTE)
    calls = []
    real = tllama._moe_routed_ffn
    monkeypatch.setattr(tllama, "_moe_routed_ffn",
                        lambda *a, **kw: calls.append(a[2].shape[0]) or real(*a, **kw))
    tkv = tkvc.create_kv_cache(2, 8, 2, PS, 16, 4, device="cpu")
    inputs, tables, lens = _prefill_inputs()
    tllama.prefill(tparams, tkv, *map(torch.from_numpy, inputs), targs)
    assert calls == [32, 32]  # both layers, T = 32
    tok, bt, ctx = _decode_inputs(tables, lens, 0, np.array([5, 6]))
    tllama.decode(tparams, tkv, *map(torch.from_numpy, (tok, bt, ctx)), targs)
    assert calls == [32, 32]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _prefill_inputs():
    """Two prompts (21 and 10 tokens) packed into T = 32 with one pad token."""
    r = np.random.default_rng(0)
    lens, T, tables = [21, 10], 32, [[0, 1], [2]]
    tok, pos, seg = np.zeros(T, np.int32), np.zeros(T, np.int32), np.zeros(T, np.int32)
    pages, slots = np.full(T, -1, np.int32), np.zeros(T, np.int32)
    t, last = 0, []
    for i, n in enumerate(lens):
        tok[t : t + n] = r.integers(1, TINY["vocab_size"], n)
        pos[t : t + n] = np.arange(n)
        seg[t : t + n] = i + 1
        pages[t : t + n] = [tables[i][p // PS] for p in range(n)]
        slots[t : t + n] = np.arange(n) % PS
        t += n
        last.append(t - 1)
    return (tok, pos, seg, pages, slots, np.array(last, np.int32)), tables, lens


def _decode_inputs(tables, lens, step, tok):
    bt = np.zeros((3, 2), np.int32)
    bt[0, :2] = tables[0]
    bt[1, :1] = tables[1]
    ctx = np.array([lens[0] + 1 + step, lens[1] + 1 + step, 0], np.int32)
    return np.array([tok[0], tok[1], 0], np.int32), bt, ctx


def _chunk_inputs(ids, start, T, table):
    """One prompt's tokens [start, start + len(ids)) packed into T rows."""
    n = len(ids)
    p = start + np.arange(n)
    z = np.zeros(T - n, np.int32)
    cat = lambda a, pad: np.concatenate([np.asarray(a, np.int32), pad])
    return (cat(ids, z), cat(p, z), cat(np.ones(n), z),
            cat(np.asarray(table)[p // PS], z - 1), cat(p % PS, z),
            np.array([n - 1], np.int32))


def _caches(targs, pages):
    args = (targs.num_layers, pages, targs.num_kv_heads, PS, targs.head_dim,
            targs.quant.kv_bits)
    return tkvc.create_kv_cache(*args, device="cpu"), jkvc.create_kv_cache(*args)


LOGITS = sorted(n for n in CONFIGS if "wide" not in n)


@pytest.mark.parametrize("name", LOGITS)
def test_prefill_then_decode_logits(name):
    """A routed 32-token packed prefill, then four masked-loop decode steps
    fed the JAX side's greedy tokens: logits within ATOL."""
    jargs, jparams, targs, tparams, _ = moe_pair(name, **ROUTE)
    tkv, jkv = _caches(targs, 8)
    inputs, tables, lens = _prefill_inputs()
    tl, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inputs), targs)
    jl, jkv = jllama.prefill(jparams, jkv, *map(jnp.asarray, inputs), jargs)
    assert tl.dtype == torch.float32 and tl.shape == (2, TINY["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = np.asarray(jl).argmax(-1)
    for step in range(4):
        inp = _decode_inputs(tables, lens, step, tok)
        tl, tkv = tllama.decode(tparams, tkv, *map(torch.from_numpy, inp), targs)
        jl, jkv = jllama.decode(jparams, jkv, *map(jnp.asarray, inp), jargs)
        assert np.isfinite(tl.numpy()).all()
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL)
        tok = np.asarray(jl)[:2].argmax(-1)


@pytest.mark.parametrize("name", LOGITS)
def test_chunk_and_mixed_logits(name):
    """A 32-token prefill, then tokens 32..52 as a routed chunk over it,
    alone and riding with a decode row (34 rows, routed): logits within
    ATOL."""
    jargs, jparams, targs, tparams, _ = moe_pair(name, **ROUTE)
    tkv, jkv = _caches(targs, 10)
    r = np.random.default_rng(3)
    short = r.integers(1, TINY["vocab_size"], 21).astype(np.int32)
    long = r.integers(1, TINY["vocab_size"], 53).astype(np.int32)
    for ids, table in ((short, [0, 1]), (long[:32], [4, 5, 6, 7])):
        inp = _chunk_inputs(ids, 0, 32, table)
        _, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inp), targs)
        _, jkv = jllama.prefill(jparams, jkv, *map(jnp.asarray, inp), jargs)
    tkv0 = tkvc.KVCache(tkv.data.clone(), tkv.scales.clone())
    inp = _chunk_inputs(long[32:], 32, 32, [4, 5, 6, 7])
    bt = np.array([[4, 5, 6, 7]], np.int32)
    tl, _ = tllama.prefill_chunk(
        tparams, tkv, *map(torch.from_numpy, inp), torch.from_numpy(bt), 32, targs)
    jl, _ = jllama.prefill_chunk(
        jparams, jkv, *map(jnp.asarray, inp), jnp.asarray(bt), jnp.int32(32), jargs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    d_tok = np.array([17, 0], np.int32)
    d_bt = np.array([[0, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    d_ctx = np.array([22, 0], np.int32)
    tl, _ = tllama.prefill_chunk_with_decode(
        tparams, tkv0, *map(torch.from_numpy, inp), torch.from_numpy(bt), 32,
        *map(torch.from_numpy, (d_tok, d_bt, d_ctx)), targs)
    jl, _ = jllama.prefill_chunk_with_decode(
        jparams, jkv, *map(jnp.asarray, inp), jnp.asarray(bt), jnp.int32(32),
        *map(jnp.asarray, (d_tok, d_bt, d_ctx)), jargs)
    assert tl.shape == (3, TINY["vocab_size"]) and np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SCHED = dict(max_num_batched_tokens=256, max_num_seqs=8, max_model_len=256,
             enable_chunked_prefill=False)
CHUNKED = dict(max_num_batched_tokens=32, enable_chunked_prefill=True)


def _engines(name, **sched):
    jargs, jparams, targs, tparams, _ = moe_pair(name, **ROUTE)
    sc = dict(SCHED, **sched)
    jsc = JSchedulerConfig(**sc)
    jcc = JCacheConfig(block_size=PS, num_device_pages=64, quant=jargs.quant)
    jengine = JLLMEngine(JWorker.create(jargs, jcc, jsc, params=jparams), jsc, jcc)
    tsc = SchedulerConfig(**sc)
    tcc = CacheConfig(block_size=PS, num_device_pages=64, quant=targs.quant)
    tengine = LLMEngine(Worker.create(targs, tcc, tsc, params=tparams, device="cpu"),
                        tsc, tcc)
    return jengine, tengine


def _run(engine, prompts, sp_cls, first_alone=False):
    """Greedy streams; with first_alone the first prompt starts decoding
    before the others arrive (with a 32-token budget the long ones then
    admit in chunks that ride with it)."""
    kw = dict(temperature=0.0, ignore_eos=True)
    outs, kinds = {}, []
    for i, p in enumerate(prompts):
        engine.add_request(f"r{i}", prompt_token_ids=p,
                           sampling_params=sp_cls(max_tokens=8, **kw))
        if first_alone and i == 0:
            engine.step()
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                outs[out.request_id] = out.outputs[0]["token_ids"]
        kinds.append(getattr(engine, "last_step_kind", None))
        assert len(kinds) < 200, "engine did not converge"
    return outs, kinds


@pytest.mark.parametrize("name,mode,seed", [
    ("w4a8kv4", "whole", 0), ("w4a8kv4", "chunked", 0),
    ("w8a8kv8", "whole", 1), ("w8a8kv8", "chunked", 0),
])
def test_greedy_streams_match_jax_engine(name, mode, seed):
    """Identical greedy streams on pinned prompts: whole prompts packed into
    one routed prefill, or chunks riding with a decode (mixed steps)."""
    r = np.random.default_rng(seed)
    if mode == "whole":
        jengine, tengine = _engines(name)
        prompts = [r.integers(1, TINY["vocab_size"], int(n)).tolist()
                   for n in r.integers(5, 40, 4)]
        first_alone = False
    else:
        jengine, tengine = _engines(name, **CHUNKED)
        prompts = [r.integers(1, TINY["vocab_size"], n).tolist() for n in (5, 100, 45)]
        first_alone = True
    want, _ = _run(jengine, prompts, JSamplingParams, first_alone)
    got, kinds = _run(tengine, prompts, SamplingParams, first_alone)
    assert len(want) == len(prompts) and got == want
    if mode == "chunked":
        assert kinds.count("mixed") >= 4


def _mixtral_config(**kw):
    return dict(
        architectures=["MixtralForCausalLM"], vocab_size=TINY["vocab_size"],
        hidden_size=TINY["hidden_size"], intermediate_size=TINY["intermediate_size"],
        num_hidden_layers=TINY["num_layers"], num_attention_heads=TINY["num_heads"],
        num_key_value_heads=TINY["num_kv_heads"], num_local_experts=4,
        num_experts_per_tok=2, **kw,
    )


@pytest.mark.parametrize("precision,group_size", [
    ("w4a8kv4", -1), ("w4a8kv8", 32), ("w8a8kv8", -1), ("w16a16kv8", -1)])
def test_engine_args_serve_mixtral(precision, group_size):
    """EngineArgs with a Mixtral config dict builds MoE layers ([L, NE, ...]
    experts, Mixtral's defaults) and serves them; the JAX package's
    single-device random-weight path built a dense model here."""
    engine = EngineArgs(
        hf_config=_mixtral_config(), random_weights=True, device="cpu",
        precision=precision, group_size=group_size, num_device_pages=32,
        block_size=PS, max_model_len=128, max_num_batched_tokens=32, max_num_seqs=4,
    ).build_engine()
    runner = engine.worker.model_runner
    args, layers = runner.model_args, runner.params.layers
    assert isinstance(layers, tllama.MoELayerParams)
    assert (args.num_experts, args.moe_top_k, args.rope_theta, args.rms_eps) == (4, 2, 1e6, 1e-5)
    assert (args.moe_route_min_tokens, args.moe_route_block) == (1024, 256)
    assert layers.gate_up[0].shape[:2] == (TINY["num_layers"], 4)
    outs, kinds = _run(engine, [[1, 2, 3], list(range(1, 51))], SamplingParams,
                       first_alone=True)
    assert len(outs["r0"]) == len(outs["r1"]) == 8
    assert "mixed" in kinds and "decode" in kinds


def test_mixtral_8x7b_geometry_and_dense_config_refusal():
    """Mixtral-8x7B's published config.json reads as its MoE geometry; the
    dense model's config reader refuses an MoE config instead of dropping the
    experts."""
    cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
               rope_theta=1e6, rms_norm_eps=1e-5, sliding_window=None,
               num_local_experts=8, num_experts_per_tok=2)
    args = tmixtral.args_from_config_dict(cfg, QuantSpec.from_precision("w4a8kv4"))
    assert (args.num_experts, args.moe_top_k, args.head_dim, args.qkv_out) == (8, 2, 128, 6144)
    assert args.sliding_window is None and args.rope_theta == 1e6
    with pytest.raises(ValueError, match="mixtral"):
        tllama.LlamaArgs.from_config_dict(cfg, QuantSpec.from_precision("w4a8kv4"))
