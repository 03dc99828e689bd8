"""Mellum2-12B-A2.5B on the port (model_type "mellum"): a window or a full
layer each, a plain RoPE on the window layers and YaRN on the full ones, 64
experts top-8 in every layer, every KV page kept.

The port's forward is held against tests/mellum_reference.py, the plain f32
model written from the config alone, at a tiny size on the CPU: one whole
period (3 window layers, then a full one), 16 query heads over 2 kv heads
(GQA 8), 8 experts top-2, a 16-token window under contexts of 40-64. The
port runs W4A8KV4 per-channel; the reference takes the port's dequantized
weights, its int8 activations and its KV4 cache values (a key from an
earlier step than the query's), so what is left between them is the port's
bf16: the residual stream, the GEMM outputs, q, k and v, the attention
probabilities in bf16. Each tolerance says why it is what it is, and the
three controls (the window on the full layer, YaRN's attention factor
dropped, YaRN on a window layer) must fail it."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import mellum_reference as ref
from qserve_tpu_torch.config import CacheConfig, QuantSpec, SchedulerConfig
from qserve_tpu_torch.engine.arg_utils import EngineArgs
from qserve_tpu_torch.engine.llm_engine import LLMEngine
from qserve_tpu_torch.kernels import kv_cache as kvc
from qserve_tpu_torch.layers import linear as lin
from qserve_tpu_torch.layers import rope
from qserve_tpu_torch.models import llama, loader, mixtral
from qserve_tpu_torch.quant import qoq
from qserve_tpu_torch.sampling_params import SamplingParams
from qserve_tpu_torch.utils import tracing
from qserve_tpu_torch.worker.worker import Worker
import torch_port_util  # noqa: F401  (one torch thread a test process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = os.path.join(ROOT, "qbench", "configs", "mellum2-12b-a2.5b.w4a8kv4.json")
PERIOD = ["sliding_attention"] * 3 + ["full_attention"]
PS = 16
W4A8KV4 = QuantSpec.from_precision("w4a8kv4")


def tiny_config(**kw) -> dict:
    """Mellum's config at a tiny size: one period, GQA 8, 8 experts top-2
    of width 32, a 16-token window; a low RoPE base and an original context
    of 32 put YaRN's ramp over dimensions that turn within these contexts."""
    cfg = dict(
        model_type="mellum", vocab_size=128, hidden_size=64, intermediate_size=7168,
        moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=16,
        num_key_value_heads=2, head_dim=32, rms_norm_eps=1e-6, num_experts=8,
        num_experts_per_tok=2, norm_topk_prob=True, attention_bias=False,
        layer_types=list(PERIOD), mlp_layer_types=["sparse"] * 4, sliding_window=16,
        use_sliding_window=True, tie_word_embeddings=False,
        rope_parameters={
            "full_attention": {"rope_type": "yarn", "rope_theta": 1000, "factor": 4,
                               "original_max_position_embeddings": 32, "beta_fast": 32,
                               "beta_slow": 1, "attention_factor": 1.2772588722239782},
            "sliding_attention": {"rope_type": "default", "rope_theta": 1000}})
    cfg.update(kw)
    return cfg


# streams of 32 rows or more take the routed dispatch in 16-row blocks (as
# tests/test_torch_mixtral.py), decode the masked loop over every expert
ROUTE = dict(moe_route_min_tokens=32, moe_route_block=16)


def _model(seed=0):
    """(config, port args, port params, the reference's weights: the port's
    dequantized linears, bf16-valued embedding, router and lm_head)."""
    cfg = tiny_config()
    args = dataclasses.replace(mixtral.args_from_config_dict(cfg, W4A8KV4), **ROUTE)
    g = torch.Generator().manual_seed(seed)
    shapes = {n: f for n, (f, _) in args.linear_shapes().items()}
    E, V, NE = args.hidden_size, args.vocab_size, args.num_experts

    def w(shape, std):  # bf16 values, as a checkpoint holds them
        return (torch.randn(shape, generator=g) * std).to(torch.bfloat16).float()

    def norm():
        return torch.rand(E, generator=g) + 0.5

    # std 0.15 gives attention scores of std ~1.4: the window and the RoPE
    # decide what each query reads
    layers = [dict(input_ln=norm(), qkv=w(shapes["qkv"], 0.15), o=w(shapes["o"], 0.05),
                   post_ln=norm(), router=w((E, NE), 1.0),
                   experts_gate_up=[w(shapes["gate_up"], 0.1) for _ in range(NE)],
                   experts_down=[w(shapes["down"], 0.05) for _ in range(NE)])
              for _ in range(args.num_layers)]
    fp = dict(embed=w((V, E), 1.0), layers=layers, final_ln=norm(), lm_head=w((E, V), 0.15))
    params = mixtral.quantize_params(fp, args, device="cpu")
    L = params.layers
    deq = [dict(layers[li],
                qkv=lin.dequantize_linear(L.qkv.layer(li)),
                o=lin.dequantize_linear(L.o.layer(li)),
                experts_gate_up=[lin.dequantize_linear(L.gate_up.layer(li).layer(e))
                                 for e in range(NE)],
                experts_down=[lin.dequantize_linear(L.down.layer(li).layer(e))
                              for e in range(NE)])
           for li in range(args.num_layers)]
    return cfg, args, params, dict(fp, layers=deq)


def act_quant(x):
    q, s, _ = qoq.quantize_activation_per_token(x)
    return q.float() * s


def kv_quant(x):
    """A key or value as the KV4 cache holds it: the bf16 value the layer
    hands over, quantized per token and head."""
    return qoq.dequantize_kv(*qoq.quantize_kv(x.to(torch.bfloat16), 4, True))


def reference(weights, cfg, ids, segments):
    return ref.forward(weights, cfg, ids, segments, act_quant=act_quant, kv_quant=kv_quant)


def _prompt_inputs(ids, start, T, table):
    """One sequence's tokens [start, start + len(ids)) packed into T rows."""
    n = len(ids)
    p = start + np.arange(n)
    z = np.zeros(T - n, np.int32)

    def cat(a, pad):
        return torch.from_numpy(np.concatenate([np.asarray(a, np.int32), pad]))

    return (cat(ids, z), cat(p, z), cat(np.ones(n), z), cat(np.asarray(table)[p // PS], z - 1),
            cat(p % PS, z), torch.tensor([n - 1], dtype=torch.int32))


def _scale(logits):
    return float(logits.max() - logits.min())


# The largest gap of a step's logits, as a share of the reference's range in
# that row. The port holds the residual stream, the GEMM outputs, q, k, v and
# the attention probabilities in bf16, and a bf16 difference moves a KV4 code
# by a step (1/15 of a head vector's range) or a router's near-tie: over 4
# layers the gap read 4.9-7.0% at seeds 0-3, its decode rows the widest.
# The weakest control, YaRN's attention factor dropped on the one full
# layer, read 10.6-15.2%; the window on the full layer 31.6-34.3%, YaRN on
# the window layers 48.5-62.5%.
TOL = 0.085


def _serve(args, params, prompt_a, prompt_b, decode_steps=4):
    """The port's logits of: prompt A's prefill (routed), `decode_steps`
    masked-loop decode steps of A (greedy), then prompt B in two chunks:
    [0, 32) alone, [32, len) riding with A's next decode row (a mixed
    step). Returns the steps' rows and the tokens A decoded."""
    cache = kvc.create_kv_cache(args.num_layers, 12, args.num_kv_heads, PS, args.head_dim,
                                4, device="cpu")
    ta, tb = [0, 1, 2, 3], [4, 5, 6, 7]
    rows = {}
    logits, cache = llama.prefill(params, cache, *_prompt_inputs(prompt_a, 0, 48, ta), args)
    rows["prefill"] = logits[0]
    toks = [int(logits[0].argmax())]
    bt = torch.tensor([ta], dtype=torch.int32)
    for step in range(decode_steps):
        ctx = torch.tensor([len(prompt_a) + step + 1], dtype=torch.int32)
        logits, cache = llama.decode(params, cache, torch.tensor([toks[-1]], dtype=torch.int32),
                                     bt, ctx, args)
        rows[f"decode{step}"] = logits[0]
        toks.append(int(logits[0].argmax()))
    _, cache = llama.prefill(params, cache, *_prompt_inputs(prompt_b[:32], 0, 32, tb), args)
    ctx = torch.tensor([len(prompt_a) + decode_steps + 1], dtype=torch.int32)
    logits, cache = llama.prefill_chunk_with_decode(
        params, cache, *_prompt_inputs(prompt_b[32:], 32, 32, tb),
        torch.tensor([tb], dtype=torch.int32), 32,
        torch.tensor([toks[-1]], dtype=torch.int32), bt, ctx, args)
    rows["chunk"], rows["mixed_decode"] = logits[0], logits[1]
    return rows, toks


def _want(weights, cfg, prompt_a, prompt_b, toks):
    """The reference's rows for _serve's: A with each decoded position its
    own step, B's two chunks two steps."""
    na, nb = len(prompt_a), len(prompt_b)
    seq_a = list(prompt_a) + toks
    seg_a = [0] * na + list(range(1, len(toks) + 1))
    la = reference(weights, cfg, seq_a, seg_a)
    lb = reference(weights, cfg, prompt_b, [0] * 32 + [1] * (nb - 32))
    want = {"prefill": la[na - 1], "chunk": lb[nb - 1], "mixed_decode": la[len(seq_a) - 1]}
    want.update({f"decode{s}": la[na + s] for s in range(len(toks) - 1)})
    return want


def _prompts(seed):
    r = np.random.default_rng(seed)
    return (r.integers(3, 128, 40).astype(np.int32), r.integers(3, 128, 60).astype(np.int32))


def _worst(got, want):
    return max(float((got[k] - want[k]).abs().max()) / _scale(want[k]) for k in want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_matches_reference_prefill_decode_chunk(seed):
    """Prefill, decode through the paged cache, a chunked prompt with a
    decode row riding along: every step's logits within TOL of the
    reference's range."""
    cfg, args, params, weights = _model(seed)
    pa, pb = _prompts(seed)
    got, toks = _serve(args, params, pa, pb)
    want = _want(weights, cfg, pa, pb, toks)
    assert set(got) == set(want)
    assert _worst(got, want) < TOL, {k: float((got[k] - want[k]).abs().max()) for k in want}


def _yarn_on_window_layers(cfg):
    rp = dict(cfg["rope_parameters"], sliding_attention=cfg["rope_parameters"]["full_attention"])
    return dict(cfg, rope_parameters=rp)


def _no_attention_factor(cfg):
    full = dict(cfg["rope_parameters"]["full_attention"], attention_factor=1.0)
    return dict(cfg, rope_parameters=dict(cfg["rope_parameters"], full_attention=full))


CONTROLS = {
    "window_on_full_layer": lambda cfg: dict(cfg, layer_types=["sliding_attention"] * 4),
    "attention_factor_dropped": _no_attention_factor,
    "yarn_on_window_layer": _yarn_on_window_layers,
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_controls_fail_the_tolerance(control, seed):
    """The reference with one mechanism wrong reads beyond TOL of the
    port's logits: the tolerance can tell each of them."""
    cfg, args, params, weights = _model(seed)
    pa, pb = _prompts(seed)
    got, toks = _serve(args, params, pa, pb)
    want = _want(weights, CONTROLS[control](cfg), pa, pb, toks)
    assert _worst(got, want) > TOL


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def _catalog():
    with open(CATALOG) as f:
        return json.load(f)


def test_yarn_range_and_frequencies_follow_the_formula():
    """Mellum's full layers: dim 128, base 5e5, factor 16 over an original
    8192 positions, beta 32 / 1: the ramp runs from dimension 18 to 35, and
    cos and sin carry the attention factor."""
    full = _catalog()["rope_parameters"]["full_attention"]
    spec = rope.spec_from_config(full, 0.0)
    assert rope.yarn_range(spec.yarn, 128, spec.theta) == (18, 35)
    d = lambda r: 128 * math.log(8192 / (2 * math.pi * r)) / (2 * math.log(5e5))
    assert (math.floor(d(32)), math.ceil(d(1))) == (18, 35)
    i = torch.arange(64, dtype=torch.float64)
    ext = 5e5 ** (-2 * i / 128)
    ramp = ((i - 18) / (35 - 18)).clamp(0, 1)
    want = ext * (1 - ramp) + ext / 16 * ramp
    got = rope.inv_freq(128, spec.theta, spec.yarn).double()
    torch.testing.assert_close(got, want, rtol=2e-6, atol=0)
    assert torch.equal(got[:18], rope.inv_freq(128, 5e5)[:18].double())  # kept
    torch.testing.assert_close(got[35:], want[35:], rtol=2e-6, atol=0)  # divided by 16
    pos = torch.tensor([0, 1, 700, 30000])
    cos, sin = rope.rope_cos_sin(pos, 128, spec.theta, spec.yarn)
    ang = pos.double()[:, None] * want[None, :]
    att = 1.2772588722239782
    torch.testing.assert_close(cos.double(), torch.cos(ang) * att, atol=2e-3, rtol=0)
    torch.testing.assert_close(sin.double(), torch.sin(ang) * att, atol=2e-3, rtol=0)
    assert float(cos[0].max()) == pytest.approx(att)
    # the port's tables against the reference's own YaRN
    ref_f, ref_att = ref.yarn_inv_freq(128, 5e5, full)
    torch.testing.assert_close(got.float(), ref_f, rtol=1e-6, atol=0)
    assert ref_att == att


def test_catalog_config_reads_as_mellum():
    """The catalog's config: 64 experts of width 896, top-8 renormalised,
    windows [1024, 1024, 1024, None] x 7, YaRN on the full layers, the plain
    RoPE at 5e5 on the window layers, and no window shared by every layer."""
    cfg = _catalog()
    args = mixtral.args_from_config_dict(cfg, W4A8KV4)
    assert (args.num_experts, args.intermediate_size, args.moe_top_k) == (64, 896, 8)
    assert (args.num_layers, args.hidden_size, args.num_heads, args.num_kv_heads,
            args.head_dim, args.vocab_size, args.rms_eps) == (28, 2304, 32, 4, 128, 98304, 1e-6)
    assert args.layer_windows == (1024, 1024, 1024, None) * 7
    assert args.sliding_window is None
    for li in range(28):
        spec = args.attn_spec(li)
        assert spec.rope.theta == 5e5
        assert (spec.rope.yarn is not None) == (li % 4 == 3)
    assert args.linear_shapes()["gate_up"][0] == (2304, 1792)
    assert args.linear_shapes()["qkv"][0] == (2304, 5120)


def test_refusals():
    """A config naming neither expert count is refused (not given 8), a
    RoPE type the port does not compute is refused by name, and the dense
    reader refuses Mellum's experts."""
    cfg = _catalog()
    no_experts = {k: v for k, v in cfg.items() if k != "num_experts"}
    with pytest.raises(ValueError, match="num_experts"):
        mixtral.args_from_config_dict(no_experts, W4A8KV4)
    mix = dict(no_experts, model_type="mixtral", layer_types=None, rope_parameters=None)
    with pytest.raises(ValueError, match="num_local_experts"):
        mixtral.args_from_config_dict(mix, W4A8KV4)
    rp = dict(cfg["rope_parameters"], full_attention=dict(
        cfg["rope_parameters"]["full_attention"], rope_type="longrope"))
    with pytest.raises(NotImplementedError, match="longrope"):
        mixtral.args_from_config_dict(dict(cfg, rope_parameters=rp), W4A8KV4)
    dense = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, rope_scaling={"rope_type": "llama3", "factor": 8.0})
    with pytest.raises(NotImplementedError, match="llama3"):
        llama.LlamaArgs.from_config_dict(dense, W4A8KV4)
    with pytest.raises(ValueError, match="mixtral"):
        llama.LlamaArgs.from_config_dict(cfg, W4A8KV4)


def test_mistral_and_mixtral_args_are_unchanged():
    """Mistral's and Mixtral's configs read as before: one window (or none)
    and one plain RoPE for every layer, no per-layer specs."""
    mistral = json.load(open(os.path.join(ROOT, "qbench", "configs",
                                          "mistral-7b-v0.1.w4a8kv4.json")))
    mixtral_cfg = json.load(open(os.path.join(ROOT, "qbench", "configs",
                                              "mixtral-8x7b-v0.1.w4a8kv4.json")))
    a = llama.LlamaArgs.from_config_dict(mistral, W4A8KV4)
    assert a == llama.LlamaArgs(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                                num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
                                rope_theta=10000.0, rms_eps=1e-5, sliding_window=4096,
                                quant=W4A8KV4)
    assert a.layer_attn == () and a.layer_windows == (4096,) * 32
    assert a.attn_spec(5) == llama.AttnSpec(4096, rope.RopeSpec(10000.0))
    m = mixtral.args_from_config_dict(mixtral_cfg, W4A8KV4)
    assert m == llama.LlamaArgs(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                                num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
                                rope_theta=1e6, rms_eps=1e-5, sliding_window=None,
                                quant=W4A8KV4, num_experts=8, moe_top_k=2)
    assert m.attn_spec(31) == llama.AttnSpec(None, rope.RopeSpec(1e6))


def _engine(cfg, **kw):
    return EngineArgs(hf_config=cfg, random_weights=True, device="cpu", num_device_pages=48,
                      block_size=PS, max_model_len=256, max_num_batched_tokens=32,
                      max_num_seqs=4, **kw).build_engine()


def test_engine_serves_mellum_and_keeps_every_page():
    """EngineArgs with model_type "mellum" builds MoE layers with the
    per-layer specs; a full layer means no cyclic page reuse: a sequence
    past the window holds one distinct page for each 16 positions. The
    scheduler counts the slots held and those below the window layers'
    window, and the MoE dispatch its live and computed rows."""
    engine = _engine(tiny_config())
    runner = engine.worker.model_runner
    assert isinstance(runner.params.layers, llama.MoELayerParams)
    assert runner.model_args.layer_windows == (16, 16, 16, None)
    assert engine.cache_config.sliding_window is None
    assert engine.scheduler.block_manager.sliding_window_pages is None
    before = tracing.totals()
    engine.add_request("a", prompt_token_ids=list(range(3, 60)),
                       sampling_params=SamplingParams(max_tokens=12, temperature=0.0,
                                                      ignore_eos=True))
    tables, kinds = [], []
    while engine.has_unfinished_requests():
        engine.step()
        kinds.append(engine.last_step_kind)
        for seq_id, t in engine.scheduler.block_manager.page_tables.items():
            tables.append(list(t))
    assert "chunk" in kinds and "decode" in kinds
    longest = max(tables, key=len)
    assert len(longest) == -(-(57 + 12) // PS) and len(set(longest)) == len(longest)
    after = tracing.totals()
    d = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert d["kv_slots_held"] > 0 and 0 < d["kv_slots_outside_window"] < d["kv_slots_held"]
    assert 0 < d["moe_live_rows"] < d["moe_expert_rows"]
    stats = engine.stats()
    assert stats["moe_live_rows"] == after["moe_live_rows"]


def test_model_directory_and_checkpoint_paths_dispatch_on_model_type(tmp_path):
    """A model directory's config.json with model_type "mellum" builds the
    MoE args in the random-weight path; the checkpoint loader reads them
    too and refuses the weights, whose tensor names the port does not know."""
    cfg = tiny_config()
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)
    engine = EngineArgs(model=str(tmp_path), random_weights=True, device="cpu",
                        num_device_pages=16, block_size=PS, max_model_len=128,
                        max_num_batched_tokens=32, max_num_seqs=2).build_engine()
    assert engine.worker.model_runner.model_args.num_experts == 8
    with pytest.raises(NotImplementedError, match="Mellum checkpoint"):
        loader.load_model(str(tmp_path), W4A8KV4, device="cpu")


def test_broadcast_layers_count_once_per_moe_layer():
    """At the default dispatch every MoE layer of a decode step takes the
    broadcast stream and counts it once in `moe_broadcast_layers`; its
    `moe_expert_rows` stay T NE, the rows that hold a token (the masked
    loop's count), and `moe_live_rows` T k. A 48-row prefill in 16-row
    blocks takes the sorted stream instead: no broadcast layer, its P rows."""
    _, args, params, _ = _model()
    L, NE, k = args.num_layers, args.num_experts, args.moe_top_k
    names = ("moe_broadcast_layers", "moe_expert_rows", "moe_live_rows")

    def counted(fn):
        before = tracing.totals()
        fn()
        after = tracing.totals()
        return tuple(after.get(n, 0) - before.get(n, 0) for n in names)

    cache = kvc.create_kv_cache(L, 12, args.num_kv_heads, PS, args.head_dim, 4, device="cpu")
    prompt, _ = _prompts(0)
    table = [0, 1, 2, 3]
    assert counted(lambda: llama.prefill(params, cache, *_prompt_inputs(prompt, 0, 48, table),
                                         args)) == (0, L * (6 + NE) * 16, L * 48 * k)
    default = dataclasses.replace(args, moe_route_min_tokens=1, moe_route_block=256)
    for B in (1, 3):  # one live row, then two padding rows beside it
        tok = torch.tensor([5] + [0] * (B - 1), dtype=torch.int32)
        bt = torch.tensor([table] * B, dtype=torch.int32)
        ctx = torch.tensor([len(prompt) + 1] + [0] * (B - 1), dtype=torch.int32)
        got = counted(lambda: llama.decode(params, cache, tok, bt, ctx, default))
        assert got == (L, L * B * NE, L * B * k), (B, got)


def test_window_layers_count_slots_below_the_window():
    """kv_slots_outside_window by hand: one running sequence of 69 tokens
    (5 pages of 16) under windows (16, 16, 16, None): (69 - 16) // 16 = 3
    pages wholly below, in each of 3 window layers."""
    cfg = tiny_config()
    args = mixtral.args_from_config_dict(cfg, W4A8KV4)
    cc = CacheConfig(block_size=PS, num_device_pages=16, quant=W4A8KV4,
                     layer_windows=args.layer_windows)
    sc = SchedulerConfig(max_num_batched_tokens=128, max_num_seqs=2, max_model_len=128)
    params = mixtral.random_quantized_params(0, args, device="cpu")
    engine = LLMEngine(Worker.create(args, cc, sc, params=params, device="cpu"), sc, cc)
    engine.add_request("a", prompt_token_ids=list(range(3, 72)),
                       sampling_params=SamplingParams(max_tokens=2, temperature=0.0,
                                                      ignore_eos=True))
    engine.step()  # the prompt
    before = tracing.totals()
    engine.step()  # the first decode step: 70 tokens, 5 pages
    after = tracing.totals()
    assert after["kv_slots_held"] - before["kv_slots_held"] == 5 * 4
    assert after["kv_slots_outside_window"] - before["kv_slots_outside_window"] == 3 * 3
