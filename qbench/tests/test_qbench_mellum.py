"""The Mellum family (qbench/families/mellum.py) and its cell,
mellum2-12b.code-repo: found by model_type, its counts worked by hand at
the published widths, its reference against tests/mellum_reference.py (the
plain forward the port's own tests hold it to), and the cell cut to a tiny
size running correct on the CPU, traced, with both of its new metrics."""

import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch

from qbench import registry
from qbench import run as qrun
from qbench.harness import Step
from qbench.reference.qoq_frozen import (
    dequant_w4_per_channel,
    fake_quant_act,
    fake_quant_kv,
    kv_scale_dtype,
)
from qbench.reference.served import Served
from qbench.weights import WeightMaker

CELL = "mellum2-12b.code-repo"
PERIOD = ["sliding_attention"] * 3 + ["full_attention"]
NEW_METRICS = {"moe_live_rows_pct.batch", "kv_outside_window_pct.batch"}


def _step(kind, spans=(), ctx=(), rows=0):
    return Step(0.0, 1.0, kind, 0, list(ctx), list(spans), rows, 0, 0)


def test_the_cell_finds_the_mellum_family_by_model_type():
    cell = registry.load_cell(CELL)
    assert cell.config["model_type"] == "mellum"
    assert os.path.basename(cell.family.__file__) == "mellum.py"
    sz = cell.family.sizes(cell.config)
    assert sz.windows == [1024, 1024, 1024, None] * 7
    assert [p["rope_type"] for p in sz.ropes[:4]] == ["default"] * 3 + ["yarn"]
    assert (sz.experts, sz.top_k, sz.inter, sz.hidden, sz.layers) == (64, 8, 896, 2304, 28)
    assert {m["name"] for m in cell.per_layer} == NEW_METRICS
    assert {m["name"] for m in cell.end_to_end} == {"output_tok_s", "setup_s"}
    assert cell.config["serving"]["max_model_len"] == 32768


def test_step_ops_by_hand():
    """Per layer, the attended keys are capped by its window: 21 layers of
    1024, 7 full."""
    cell = registry.load_cell(CELL)
    fam, sz = cell.family, cell.family.sizes(cell.config)
    # qkv 2304 x 5120, o 4096 x 2304, the router 2304 x 64, 8 experts of
    # gate_up 2304 x 1792 and down 896 x 2304
    per_tok_layer = 2304 * 5120 + 4096 * 2304 + 2304 * 64 + 8 * (2304 * 1792 + 896 * 2304)
    assert per_tok_layer == 70_926_336
    dec = _step("decode", ctx=[100, 1024, 1025, 5000], rows=4)
    keys = 21 * (100 + 1024 + 1024 + 1024) + 7 * (100 + 1024 + 1025 + 5000)
    want = 2 * 4 * 28 * per_tok_layer + 2 * 4 * 2304 * 98304 + 4 * 32 * 128 * keys
    assert fam.step_ops(dec, sz) == want
    chunk = _step("chunk", spans=[(4000, 6048)], rows=1)
    keys = 21 * 2048 * 1024 + 7 * (6048 * 6049 - 4000 * 4001) // 2
    want = 2 * 2048 * 28 * per_tok_layer + 2 * 2304 * 98304 + 4 * 32 * 128 * keys
    assert fam.step_ops(chunk, sz) == want


def test_paged_attention_bound_by_hand():
    """K4's bytes a row and layer: 576 B a cached key (KV4 codes of k and v,
    4 kv heads x 128, and their f32 scale and zero: 2 x 4 x 2 x 4), the
    current k and v (2048 B), q and o (16384 B), 4 B a page of its table; a
    window layer's row reads its last 1024 keys."""
    cell = registry.load_cell(CELL)
    fam, sz = cell.family, cell.family.sizes(cell.config)

    def row(c):
        return 576 * (c - 1) + 2048 + 16384 + 4 * -(-c // 256)

    ctx = [100, 1024, 1025, 5000]
    window = sum(row(min(c, 1024)) for c in ctx)
    full = sum(row(c) for c in ctx)
    assert (window, full) == (1_898_548, 4_189_368)
    got = fam.paged_attn_bound_s(_step("decode", ctx=ctx, rows=4), sz)
    assert got == pytest.approx((21 * window + 7 * full) / 3.35e12, rel=1e-12)
    assert fam.paged_attn_bound_s(_step("chunk", spans=[(0, 2048)], rows=1), sz) == 0.0


def tiny_cell(limits=(1.0, 0.1)):
    """The cell cut to tiny widths on the CPU: one period (3 window layers
    of 32, a full one), 16 query heads over 2 kv heads of 32, 8 experts
    top-2 of width 64, 512 ids, pages of 16, a 64-token budget; prompts of
    40-150 tokens (past the window), outputs of 4-30, 4 clients."""
    cell = registry.load_cell(CELL)
    cfg, tr = cell.config, cell.traffic
    cfg.update(vocab_size=512, hidden_size=64, moe_intermediate_size=64, num_hidden_layers=4,
               num_attention_heads=16, num_key_value_heads=2, head_dim=32, num_experts=8,
               num_experts_per_tok=2, sliding_window=32, layer_types=list(PERIOD),
               mlp_layer_types=["sparse"] * 4)
    full = dict(cfg["rope_parameters"]["full_attention"], rope_theta=1000,
                original_max_position_embeddings=64, factor=4)
    cfg["rope_parameters"] = {"full_attention": full,
                              "sliding_attention": {"rope_type": "default", "rope_theta": 1000}}
    cfg["serving"].update(page_size=16, max_num_batched_tokens=64, max_num_seqs=16,
                          max_model_len=512)
    tr.update(clients=4, warmup_steps=5, deck_size=64)
    tr["prompt_len"].update(median=80, min=40, max=150)
    tr["output_len"].update(median=10, min=4, max=30)
    tr["check"].update(requests=4, scored_tokens=30)
    # the stds scaled to the widths (64 against 2304: x 6)
    std = cfg["assumed"]["weight_std"]
    std.update({k: 6 * v for k, v in std.items()})
    cell.name = "tiny." + cell.name
    cell.limits = {"logit_gap": {"limit": limits[0]}, "mean_gap": {"limit": limits[1]}}
    return cell


def _routed(cell):
    """Chunks of 32 rows or more route, in 16-row blocks (the plain paths';
    the card's kernels take multiples of 64), decode runs the masked loop."""
    return dataclasses.replace(cell.family.program(cell.config).args, moe_route_min_tokens=32,
                               moe_route_block=16)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_reference_equals_the_tests_plain_forward(seed):
    """qbench/reference/mellum.py and tests/mellum_reference.py, written
    apart, on the same seeded tiny weights (W4 dequantized, int8
    activations, KV4 for keys from an earlier step): equal logits."""
    sys.path.insert(0, os.path.join(registry.ROOT, "tests"))
    try:
        import mellum_reference as plain
    finally:
        sys.path.pop(0)
    cell = tiny_cell()
    cfg, fam = cell.config, cell.family
    sz = fam.sizes(cfg)
    maker = WeightMaker(seed, cfg, "cpu", sz)
    ref = fam.Reference(maker)
    rng = np.random.default_rng(11)
    seqs = [Served(prompt=rng.integers(3, 512, n).astype(np.int64),
                   tokens=rng.integers(3, 512, t).astype(np.int64), chunk_ends=ends, scored=s)
            for n, ends, t, s in ((90, [32, 64, 90], 20, 20), (50, [50], 12, 6))]
    got = ref.served_logits(seqs)
    fp = fam.float_params(maker)
    layers = [dict(input_ln=l["input_ln"], qkv=dequant_w4_per_channel(l["qkv"]),
                   o=dequant_w4_per_channel(l["o"]), post_ln=l["post_ln"], router=l["router"],
                   experts_gate_up=[dequant_w4_per_channel(w) for w in l["experts_gate_up"]],
                   experts_down=[dequant_w4_per_channel(w) for w in l["experts_down"]])
              for l in fp["layers"]]
    weights = dict(embed=fp["embed"], layers=layers, final_ln=fp["final_ln"],
                   lm_head=fp["lm_head"])
    gaps = []
    for s, g in zip(seqs, got):
        ids = np.concatenate([s.prompt, s.tokens[:-1]])
        want = plain.forward(weights, cfg, ids, s.segments(),
                             act_quant=lambda x: fake_quant_act(x, 8),
                             kv_quant=lambda x: fake_quant_kv(x, 4, kv_scale_dtype(2)))
        want = want[-s.scored:]
        gaps.append((g - want).abs().amax(dim=-1) / (want.amax(dim=-1) - want.amin(dim=-1)))
    # The two sum in other orders, and the int8 activation and KV4 roundings
    # are steps: an f32 ulp apart flips a code now and then, and a flipped
    # code can move a router's near-tie. So a sequence agrees to f32 (2e-7 of
    # each row's range) or, after such a flip early in it, reads 0.1-1.2%
    # apart (seeds 7-9); a wrong window or RoPE moves every row by 10-60%
    # (tests/test_torch_mellum.py).
    gaps = torch.cat(gaps)
    assert float(gaps.median()) < 0.01 and float(gaps.max()) < 0.03, gaps


def test_the_program_that_reads_no_window_a_layer_is_refused(monkeypatch):
    """The parent's port reads a Mellum config as Mixtral's (8 experts of
    width 7168, no window a layer): the family refuses it before making any
    weight, so the run stops at once."""
    from qserve_tpu_torch.models import mixtral

    cell = registry.load_cell(CELL)
    orig = mixtral.args_from_config_dict

    def mixtral_reading(cfg, quant):
        cfg = {k: v for k, v in cfg.items()
               if k not in ("layer_types", "rope_parameters", "model_type")}
        return dataclasses.replace(orig(dict(cfg, num_local_experts=8), quant),
                                   intermediate_size=cfg["intermediate_size"])

    monkeypatch.setattr(mixtral, "args_from_config_dict", mixtral_reading)
    with pytest.raises(RuntimeError, match="mellum"):
        cell.family.program(cell.config)


def test_tiny_cell_runs_correct_traced_with_its_metrics():
    cell = tiny_cell()
    out = qrun.run_cell(cell, 2**31 + 7, 2.0, True, "cpu", time.perf_counter(),
                        args=_routed(cell))
    assert out["correct"], out["checks"]
    assert out["checks"]["mean_gap"]["tokens"] > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == NEW_METRICS, m
    # top-2 of 8: the masked loop's rows are 25% live, a routed chunk's more
    assert 25.0 <= m["moe_live_rows_pct.batch"] < 100.0
    # contexts of 40-180 tokens over a 32-token window, in 3 layers of 4
    assert 0.0 < m["kv_outside_window_pct.batch"] < 75.0
