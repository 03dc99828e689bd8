"""Port parity: activation-aware scale optimization
(qserve_tpu_torch/quant/optimize.py) against the JAX package's
quant/optimize.py, on tests/test_quant_optimize.py's geometry and its
outlier-heavy random model, plus the port's own properties (the folds are
float no-ops, the optimized model quantizes better than RTN).

Tolerances, from the measured gaps:
  * calibrate's stats: max |port - JAX| within STATS_RTOL of max |JAX| per
    statistic (measured at most 1.6e-2: both run bf16 products, and a bf16
    neighbour flip in layer 0 moves layer 1's activations);
  * smooth_layer given the same stats: f32 rounding, rtol 1e-6 (measured
    2.4e-7);
  * clip_weight: the chosen ratio equal on every (group, column) whose two
    best grid errors are more than TIE_RTOL apart, and the clipped weights
    there within 1e-6;
  * optimize_float_params end to end: each layer weight within
    ENDTOEND_RTOL at ENDTOEND_SHARE of its elements (the stats' gap reaches
    the smoothing scales through amax^alpha; clip ties move a few columns
    further: measured shares 0.998-1.0), and the quantized models'
    teacher-forced NLL within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.config import QuantSpec as JQuantSpec
from qserve_tpu.models import llama as jllama
from qserve_tpu.quant import optimize as joptimize
from qserve_tpu_torch.config import QuantSpec as TQuantSpec
from qserve_tpu_torch.kernels import attention, ops
from qserve_tpu_torch.layers import rope
from qserve_tpu_torch.models import llama as tllama
from qserve_tpu_torch.quant import optimize, qoq

GEO = dict(vocab_size=384, hidden_size=128, intermediate_size=256, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=32)
STATS_RTOL = 3e-2
TIE_RTOL = 1e-4
ENDTOEND_RTOL = 2e-2
ENDTOEND_SHARE = 0.99
FLAGS = [
    dict(smooth_attn=False, smooth_v=False),
    dict(smooth_attn=True, smooth_v=False),
    dict(smooth_attn=False, smooth_v=True),
    dict(smooth_attn=True, smooth_v=True),
]


def _args(gs=-1, wb=4):
    precision = "w4a8kv4" if wb == 4 else "w8a8kv8"
    return (jllama.LlamaArgs(**GEO, quant=JQuantSpec.from_precision(precision, gs)),
            tllama.LlamaArgs(**GEO, quant=TQuantSpec.from_precision(precision, gs)))


def _fp_with_outliers(args, outlier_mag=30.0):
    """tests/test_quant_optimize.py's model: 5% of the embedding's columns
    boosted, so the hidden activations carry outlier channels."""
    fp = jllama.random_float_params(jax.random.PRNGKey(0), args)
    chan = jax.random.uniform(jax.random.PRNGKey(99), (args.hidden_size,)) < 0.05
    fp["embed"] = fp["embed"] * jnp.where(chan, outlier_mag, 1.0)[None, :]
    return fp


def _windows(vocab, n=4, T=64):
    return np.random.RandomState(0).randint(0, vocab, size=(n, T)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    jargs, targs = _args()
    fp = _fp_with_outliers(jargs)
    win = _windows(GEO["vocab_size"])
    jstats = joptimize.calibrate(fp, jargs, win, batch=4)
    return jargs, targs, fp, win, jstats


def test_calibrate_stats_match_jax(model):
    jargs, targs, fp, win, jstats = model
    # batch 3 over 4 windows: two batches of unequal size, merged as the JAX
    # package merges them (max of absmaxes, mean of the batches' means)
    tstats = optimize.calibrate(_np(fp), targs, win, batch=3, device="cpu")
    jstats3 = joptimize.calibrate(fp, jargs, win, batch=3)
    assert len(tstats) == GEO["num_layers"]
    for jst, tst in zip(jstats3, tstats):
        for name, want, got in zip(jst._fields, jst, tst):
            want = np.asarray(want)
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
            gap = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert gap <= STATS_RTOL, (name, gap)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: f"attn{int(f['smooth_attn'])}-v{int(f['smooth_v'])}")
def test_smooth_layer_matches_jax(model, flags):
    jargs, targs, fp, win, jstats = model
    for li in range(GEO["num_layers"]):
        jst = jstats[li]
        tst = optimize.LayerStats(*(_t(v) for v in jst))
        jl, jsc = joptimize.smooth_layer(fp["layers"][li], jst, jargs, **flags)
        tl, tsc = optimize.smooth_layer(_np(fp["layers"][li]), tst, targs, **flags)
        for k in jl:
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=k)
        for k in jsc:
            np.testing.assert_allclose(tsc[k].numpy(), np.asarray(jsc[k]), rtol=1e-6,
                                       err_msg=k)


def test_clip_ratio_grid_matches_jax():
    """The port's grid is jnp.linspace's under jit, bit for bit."""
    for n, m in ((16, 0.5), (8, 0.5), (16, 0.05), (8, 0.05), (16, 0.3), (1, 0.5)):
        want = np.asarray(jax.jit(lambda: jnp.linspace(1.0, m, n))())
        np.testing.assert_array_equal(optimize.clip_ratios(n, m).numpy(), want)


def _grid_errors(w, act_ms, group_size, n_grid, min_ratio):
    """float64 errors of every grid ratio [n_grid, G, N] (the test's own)."""
    K, N = w.shape
    G = K // group_size if group_size > 0 else 1
    wg = w.astype(np.float64).reshape(G, K // G, N)
    am = act_ms.astype(np.float64).reshape(G, K // G, 1)
    gmax, gmin = wg.max(axis=1, keepdims=True), wg.min(axis=1, keepdims=True)
    errs = []
    for r in optimize.clip_ratios(n_grid, min_ratio).numpy().astype(np.float64):
        scale = np.maximum(gmax * r - gmin * r, 1e-8) / 15
        zero = np.clip(np.round(-gmin * r / scale), 0, 15)
        q = np.clip(np.round(wg / scale) + zero, 0, 15)
        errs.append((am * (wg - (q - zero) * scale) ** 2).sum(axis=1))
    return np.stack(errs)


@pytest.mark.parametrize("group_size,min_ratio", [(-1, 0.5), (64, 0.5), (-1, 0.05)])
def test_clip_weight_matches_jax_away_from_ties(group_size, min_ratio):
    rng = np.random.default_rng(7)
    K, N = 256, 96
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[:4] *= 20.0  # outlier rows on low-activation channels
    act_ms = (np.abs(rng.standard_normal(K)) + 0.1).astype(np.float32)
    act_ms[:4] = 1e-4
    want = np.asarray(joptimize.clip_weight(jnp.asarray(w), jnp.asarray(act_ms), bits=4,
                                            group_size=group_size, min_ratio=min_ratio))
    got = optimize.clip_weight(_t(w), _t(act_ms), bits=4, group_size=group_size,
                               min_ratio=min_ratio).numpy()
    errs = np.sort(_grid_errors(w, act_ms, group_size, 16, min_ratio), axis=0)
    G = K // group_size if group_size > 0 else 1
    apart = (errs[1] - errs[0]) > TIE_RTOL * errs[0]  # [G, N]
    assert apart.mean() > 0.9, apart.mean()
    rows = np.repeat(apart, K // G, axis=0)  # [K, N]
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-6, atol=1e-7)
    # never outside the original range
    assert np.abs(got).max() <= np.abs(w).max()


def test_clip_reduces_weighted_error():
    """Outlier weights on near-silent input channels clip almost for free
    (the JAX package's TestClipSearch case, on the port)."""
    g = torch.Generator().manual_seed(7)
    K, N = 256, 128
    w = torch.randn((K, N), generator=g)
    w[:4] *= 20.0
    act_ms = torch.ones(K)
    act_ms[:4] = 1e-4

    def werr(src):
        deq = qoq.dequantize_per_channel(qoq.quantize_weight_per_channel(src))
        return float((act_ms[:, None] * (deq - w) ** 2).sum())

    clipped = optimize.clip_weight(w, act_ms, bits=4, group_size=-1, min_ratio=0.05)
    assert werr(clipped) < werr(w) * 0.2


def _nll(params, args, toks):
    nll, _ = tllama.teacher_forced_nll(params, torch.from_numpy(toks), len(toks), args,
                                       row_chunk=16)
    return float(nll)


@pytest.mark.parametrize("gs", [-1, 32])
def test_optimize_float_params_matches_jax(gs):
    jargs, targs = _args(gs=gs)
    fp = _fp_with_outliers(jargs, outlier_mag=40.0)
    win = _windows(GEO["vocab_size"])
    want = joptimize.optimize_float_params(fp, jargs, win, calib_batch=4, clip_grid=8)
    got = optimize.optimize_float_params(_np(fp), targs, win, calib_batch=4, clip_grid=8,
                                         device="cpu")
    for jl, tl in zip(want["layers"], got["layers"]):
        for k in ("input_ln", "qkv", "o", "post_ln", "gate_up", "down"):
            a, b = tl[k].numpy(), np.asarray(jl[k])
            share = np.isclose(a, b, rtol=ENDTOEND_RTOL, atol=1e-6).mean()
            assert share >= ENDTOEND_SHARE, (k, share)
    toks = win[0]
    nll_j = _nll(tllama.quantize_params(_np(want), targs, device="cpu"), targs, toks)
    nll_t = _nll(tllama.quantize_params(got, targs, device="cpu"), targs, toks)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-3)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: f"attn{int(f['smooth_attn'])}-v{int(f['smooth_v'])}")
def test_folds_preserve_float_forward(model, flags):
    """The port's folds are float no-ops on the port's f32 oracle."""
    jargs, targs, fp, win, _ = model
    fpn = _np(fp)
    stats = optimize.calibrate(fpn, targs, win, batch=4, device="cpu")
    toks = torch.from_numpy(win[0])
    base = tllama.reference_forward_float(fpn, targs, toks)
    fp2 = dict(fpn, layers=[optimize.smooth_layer(fl, st, targs, **flags)[0]
                            for fl, st in zip(fpn["layers"], stats)])
    out = tllama.reference_forward_float(fp2, targs, toks)
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=2e-4, atol=2e-4)


def _quantized_logits(params, args, toks):
    """Teacher-forced quantized forward -> full f32 logits (tiny T)."""
    T = len(toks)
    tok = torch.from_numpy(toks)
    h = params.embed[tok.long()].to(torch.bfloat16)
    cos, sin = rope.rope_cos_sin(torch.arange(T, dtype=torch.int32), args.head_dim,
                                 args.rope_theta)
    seg = torch.ones(T, dtype=torch.int32)
    h, _ = tllama._run_layers(params, h, cos, sin, args,
                              lambda q, k, v, _li: attention.prefill_attention(q, k, v, seg))
    h = ops.rmsnorm(h, params.final_ln, args.rms_eps)
    return ops.matmul(h, params.lm_head, torch.float32)


@pytest.mark.parametrize("gs", [-1, 32])
def test_optimized_quant_beats_rtn(gs):
    """On the outlier-heavy model the optimized model's quantized logits sit
    closer to the float model's than RTN's do (the JAX package's
    TestEndToEnd property, on the port)."""
    jargs, targs = _args(gs=gs)
    fpn = _np(_fp_with_outliers(jargs, outlier_mag=40.0))
    win = _windows(GEO["vocab_size"])
    fp_opt = optimize.optimize_float_params(fpn, targs, win, calib_batch=4, clip_grid=8,
                                            device="cpu")
    toks = win[0]
    ref = tllama.reference_forward_float(fpn, targs, torch.from_numpy(toks))

    def quant_err(src):
        out = _quantized_logits(tllama.quantize_params(src, targs, device="cpu"), targs, toks)
        return float(((out - ref) ** 2).mean())

    e_rtn, e_opt = quant_err(fpn), quant_err(fp_opt)
    assert e_opt < e_rtn, (e_rtn, e_opt)


def test_load_calib_windows_match_jax(tmp_path):
    data = np.random.default_rng(0).integers(0, 256, 20000).astype(np.uint8)
    data.tofile(tmp_path / "train.bin")
    got = optimize.load_calib_windows(str(tmp_path), n_windows=8, seqlen=128)
    want = joptimize.load_calib_windows(str(tmp_path), n_windows=8, seqlen=128)
    assert got.dtype == np.int32 and got.shape == (8, 128)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 256).all()


def test_optimize_rejects_moe():
    _, targs = _args()
    with pytest.raises(NotImplementedError):
        optimize.optimize_float_params({}, dataclasses.replace(targs, num_experts=4),
                                       np.zeros((1, 8), np.int32), device="cpu")
