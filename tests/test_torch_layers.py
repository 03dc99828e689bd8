"""Port parity: the four linear flavors, RoPE, the sampler's top-k/top-p
kept sets, the host marshal, the cache engine's page copies and swaps, and
the kernel build's digest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu import native as jnative
from qserve_tpu.layers import linear as jlin
from qserve_tpu.layers import rope as jrope
from qserve_tpu.layers import sampler as jsampler
from qserve_tpu_torch import native as tnative
from qserve_tpu_torch.config import CacheConfig, QuantSpec
from qserve_tpu_torch.layers import linear as tlin
from qserve_tpu_torch.layers import rope as trope
from qserve_tpu_torch.layers import sampler as tsampler
from qserve_tpu_torch.worker.cache_engine import CacheEngine
from torch_port_util import bf16_ulps, to_np, to_torch


def test_rope_cos_sin_and_apply():
    pos = np.arange(0, 300, 7, dtype=np.int32)
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), 64, 500000.0)
    ct, st = trope.rope_cos_sin(torch.from_numpy(pos), 64, 500000.0)
    # cos/sin are each side's own f32 transcendental: within 2 f32 ulps
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=2.4e-7)
    x = np.random.default_rng(0).standard_normal((len(pos), 4, 64)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(to_np(xt)).astype(jnp.bfloat16)
    got = trope.apply_rope(xt, torch.from_numpy(np.array(cj)), torch.from_numpy(np.array(sj)))
    want = to_torch(jrope.apply_rope(xj, cj, sj))
    assert bf16_ulps(got, want) <= 1


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (7, 0.5), (1, 0.9)])
def test_threshold_mask_kept_sets(top_k, top_p):
    scaled = (np.random.default_rng(1).standard_normal((4, 200)) * 2).astype(np.float32)
    tk = np.array([top_k, 0, top_k, 3], np.int32)
    tp = np.array([top_p, top_p, 1.0, 0.95], np.float32)
    want = np.asarray(jsampler.threshold_mask(jnp.asarray(scaled), jnp.asarray(tp),
                                              jnp.asarray(tk))) > -1e29
    got = tsampler.threshold_mask(torch.from_numpy(scaled), torch.from_numpy(tp),
                                  torch.from_numpy(tk)).numpy() > -1e29
    np.testing.assert_array_equal(got, want)


def test_sample_greedy_and_filtered_on_cpu():
    logits = torch.from_numpy(
        np.random.default_rng(2).standard_normal((3, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    greedy = tsampler.sample(logits, torch.zeros(3), torch.ones(3),
                             torch.zeros(3, dtype=torch.int32), gen)
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jsampler.sample(
            jnp.asarray(logits.numpy()), jnp.zeros(3), jnp.ones(3),
            jnp.zeros(3, jnp.int32), jax.random.PRNGKey(0))))
    # top_k=1 at any temperature keeps only the argmax
    picked = tsampler.sample(logits, torch.full((3,), 0.8), torch.ones(3),
                             torch.ones(3, dtype=torch.int32), gen)
    np.testing.assert_array_equal(picked.numpy(), greedy.numpy())


def _filtered_case(seed, B=6, V=300):
    r = np.random.default_rng(seed)
    logits = (r.standard_normal((B, V)) * 2).astype(np.float32)
    u = r.random((B, V)).astype(np.float32).clip(2.0**-24, None)
    return logits, -np.log(-np.log(u))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (7, 0.5), (40, 0.95)])
def test_filtered_draw_with_injected_noise(top_k, top_p):
    """The port's filtered draw under a given Gumbel noise tensor is the
    argmax of that noise over the JAX package's kept sets; greedy and
    unfiltered rows ride in the same batch."""
    logits, noise = _filtered_case(3)
    temp = np.array([0.8, 0.0, 1.3, 0.8, 0.5, 0.0], np.float32)
    tk = np.array([top_k, 0, top_k, 0, 3, 9], np.int32)
    tp = np.array([top_p, 1.0, 1.0, 1.0, top_p, 0.3], np.float32)
    got = tsampler.sample(
        torch.from_numpy(logits), torch.from_numpy(temp), torch.from_numpy(tp),
        torch.from_numpy(tk), torch.Generator().manual_seed(0),
        noise=torch.from_numpy(noise),
    ).numpy()
    sampling = temp > 0
    filt = sampling & ((tk > 0) | (tp < 1.0))
    scaled = logits / np.maximum(temp, 1e-6)[:, None]
    masked = jsampler.threshold_mask(
        jnp.asarray(scaled), jnp.asarray(np.where(filt, tp, 1.0).astype(np.float32)),
        jnp.asarray(np.where(filt, tk, 0).astype(np.int32)))
    want = np.where(sampling, np.asarray(masked + noise).argmax(-1),
                    logits.argmax(-1))
    np.testing.assert_array_equal(got, want)


def test_filtered_draw_keeps_ties_at_kth_value():
    """top_k = 3 with the 3rd, 4th and 5th largest values equal keeps all
    five; noise that favours the 5th makes it the draw."""
    logits, noise = _filtered_case(4, B=2, V=64)
    order = np.argsort(-logits[0])
    logits[0, order[3:5]] = logits[0, order[2]]
    noise[0] = 0.0
    noise[0, order[4]] = 0.5  # wins among the tied values, not over rank 6
    noise[0, order[5]] = 50.0  # outside the kept set whatever its noise
    args = (torch.from_numpy(logits), torch.ones(2), torch.ones(2),
            torch.tensor([3, 3], dtype=torch.int32), torch.Generator().manual_seed(0))
    kept = tsampler.threshold_mask(torch.from_numpy(logits), torch.ones(2),
                                   torch.tensor([3, 3], dtype=torch.int32)) > -1e29
    assert kept[0].sum() == 5 and kept[1].sum() == 3
    want_kept = np.asarray(jsampler.threshold_mask(
        jnp.asarray(logits), jnp.ones(2), jnp.asarray([3, 3], jnp.int32))) > -1e29
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    got = tsampler.sample(*args, noise=torch.from_numpy(noise)).numpy()
    cand = order[:5]
    assert got[0] == cand[np.argmax((logits[0] + noise[0])[cand])]


@pytest.mark.parametrize("top_p", [1e-6, 0.0])
def test_filtered_draw_tiny_top_p_keeps_the_argmax(top_p):
    logits, noise = _filtered_case(5)
    B = logits.shape[0]
    got = tsampler.sample(
        torch.from_numpy(logits), torch.full((B,), 0.9), torch.full((B,), top_p),
        torch.zeros(B, dtype=torch.int32), torch.Generator().manual_seed(0),
        noise=torch.from_numpy(noise),
    ).numpy()
    np.testing.assert_array_equal(got, logits.argmax(-1))


def test_filtered_draw_own_generator_stays_in_kept_set():
    """Without injected noise the CPU draw comes from the torch.Generator:
    it repeats for the same seed and never leaves the kept set."""
    logits, _ = _filtered_case(6)
    B = logits.shape[0]
    lt, temp = torch.from_numpy(logits), torch.full((B,), 0.8)
    tp, tk = torch.full((B,), 0.8), torch.full((B,), 10, dtype=torch.int32)
    kept = tsampler.threshold_mask(lt / 0.8, tp, tk) > -1e29
    draws = [tsampler.sample(lt, temp, tp, tk, torch.Generator().manual_seed(s))
             for s in (1, 1, 2, 3, 4, 5)]
    assert torch.equal(draws[0], draws[1])
    for d in draws:
        assert bool(kept[torch.arange(B), d.long()].all())
    assert len({tuple(d.tolist()) for d in draws}) > 1


def test_filtered_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version in its place."""
    from qserve_tpu_torch.kernels import sampler as ksampler

    with pytest.raises(ValueError, match="CUDA"):
        ksampler.sample_filtered(torch.zeros(2, 8), torch.ones(2, dtype=torch.int32),
                                 torch.ones(2), True, True)


def test_pack_prefill_and_decode_match():
    prompts = [[5, 6, 7], list(range(1, 21)), [9]]
    tables = [[4], [0, 2], [7]]
    want = jnative.pack_prefill(prompts, tables, 16, 32, 4)
    got = tnative.pack_prefill(prompts, tables, 16, 32, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = jnative.pack_decode([3, 4], [4, 21], [[4], [0, 2]], 4, 3)
    got = tnative.pack_decode([3, 4], [4, 21], [[4], [0, 2]], 4, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cache_engine_copy_and_swap():
    cc = CacheConfig(block_size=4, num_device_pages=6, num_cpu_pages=2,
                     quant=QuantSpec.from_precision("w4a8kv4"))
    ce = CacheEngine(2, 2, 32, cc, device="cpu")
    r = np.random.default_rng(3)
    ce.cache.data.copy_(torch.from_numpy(
        r.integers(-128, 128, ce.cache.data.shape).astype(np.int8)))
    ce.cache.scales.copy_(torch.from_numpy(r.random(ce.cache.scales.shape).astype(np.float32)))
    before = [a.clone() for a in ce.cache]
    ce.copy({1: [3, 4]})
    for a, b in zip(ce.cache, before):
        assert torch.equal(a[:, 3], b[:, 1]) and torch.equal(a[:, 4], b[:, 1])
        assert torch.equal(a[:, 0], b[:, 0])
    ce.swap_out({2: 0})
    for a in ce.cache:
        a[:, 2] = 0
    ce.swap_in({0: 5})
    for a, b in zip(ce.cache, before):
        assert torch.equal(a[:, 5], b[:, 2])
    assert not ce.cpu_pool


FLAVORS = {"w4-chn": (4, -1), "w4-g128": (4, 128), "w4-g64": (4, 64),
           "w8": (8, -1), "w16": (16, -1)}


def _linear_pair(flavor, K=256, N=96, seed=20):
    bits, gs = FLAVORS[flavor]
    w = (np.random.default_rng(seed).standard_normal((K, N)) * 0.05).astype(np.float32)
    return (w, jlin.quantize_linear_from_float(jnp.asarray(w), bits, gs),
            tlin.quantize_linear_from_float(torch.from_numpy(w), bits, gs))


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_quantize_and_dequantize_linear_bitexact(flavor):
    """quantize_linear_from_float gives the JAX package's fields bit for
    bit; the JAX params carried across by field name dequantize to exactly
    the JAX package's reconstruction."""
    from qserve_tpu_torch.convert.from_jax import tensor_from_numpy

    _, pj, pt = _linear_pair(flavor)
    gs = FLAVORS[flavor][1] if FLAVORS[flavor][1] > 0 else 128
    assert type(pt).__name__ == type(pj).__name__ and pt._fields == pj._fields
    for name, a, b in zip(pj._fields, pt, pj):
        np.testing.assert_array_equal(to_np(a), np.asarray(b, to_np(a).dtype),
                                      err_msg=name)
    carried = type(pt)(*(tensor_from_numpy(np.asarray(x), "cpu") for x in pj))
    np.testing.assert_array_equal(
        tlin.dequantize_linear(carried, gs).numpy(),
        np.asarray(jlin.dequantize_linear(pj, gs)))
    assert tlin.needs_act_sum(pt) == jlin.needs_act_sum(pj)


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_apply_linear_matches_jax(flavor):
    """apply_linear over every flavor: the integer flavors equal the JAX
    package's bf16 output bit for bit (the per-channel one within a bf16
    step, its epilogue subtracts two rounded products); W16 sums bf16
    products in f32 in another order: one bf16 step."""
    from qserve_tpu.kernels import ops as jops

    _, pj, pt = _linear_pair(flavor)
    gs = FLAVORS[flavor][1] if FLAVORS[flavor][1] > 0 else 128
    x = np.random.default_rng(21).standard_normal((9, 256)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(to_np(xt)).astype(jnp.bfloat16)
    if flavor == "w16":
        got, want = tlin.apply_linear(pt, xt, gs), jlin.apply_linear(pj, xj, gs)
        assert bf16_ulps(got, to_torch(want)) <= 1
        return
    with_sum = tlin.needs_act_sum(pt)
    qj = jlin.QuantAct(*jops.quant_per_token(xj, with_sum))
    qt = tlin.QuantAct(*(to_torch(a) if a is not None else None for a in qj))
    got, want = tlin.apply_linear(pt, qt, gs), jlin.apply_linear(pj, qj, gs)
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, to_torch(want)) <= (1 if flavor == "w4-chn" else 0)
    if flavor != "w4-chn":  # f32 output, the W8 lm_head's
        got = tlin.apply_linear(pt, qt, gs, torch.float32)
        want = jlin.apply_linear(pj, qj, gs, jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_linear_refuses_the_wrong_activation():
    _, _, p16 = _linear_pair("w16")
    _, _, p8 = _linear_pair("w8")
    _, _, pchn = _linear_pair("w4-chn")
    q = tlin.QuantAct(torch.zeros(2, 256, dtype=torch.int8), torch.ones(2, 1), None)
    with pytest.raises(TypeError, match="float"):
        tlin.apply_linear(p16, q)
    with pytest.raises(TypeError, match="QuantAct"):
        tlin.apply_linear(p8, torch.zeros(2, 256, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="act-sum"):
        tlin.apply_linear(pchn, q)


def test_stacked_layer_views_copy_nothing():
    for flavor in sorted(FLAVORS):
        _, _, p = _linear_pair(flavor)
        stacked = type(p)(*(torch.stack([x, x]) for x in p))
        view = stacked.layer(1)
        assert type(view) is type(p)
        for v, s_, x in zip(view, stacked, p):
            assert v.data_ptr() == s_[1].data_ptr() and torch.equal(v, x)


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """A kernel library's file name carries a digest of its source AND of
    every csrc/*.cuh, so an edit to a shared header rebuilds it."""
    from qserve_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n')
    (csrc / "b.cu").write_text("// no include\n")
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {s: _build._target(s) for s in ("a.cu", "b.cu")}
    assert before == {s: _build._target(s) for s in ("a.cu", "b.cu")}
    (csrc / "common.cuh").write_text("// v2\n")
    after = {s: _build._target(s) for s in ("a.cu", "b.cu")}
    assert all(before[s] != after[s] for s in before)
    (csrc / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build._target("a.cu") != after["a.cu"]
    assert _build._target("b.cu") == after["b.cu"]
    # the real tree: every source is there, and the two shared headers
    monkeypatch.undo()
    import os
    names = set(os.listdir(_build.CSRC))
    assert {"attn_common.cuh", "gemm_common.cuh", "w4a8_gemm_per_group.cu",
            "w8a8_gemm.cu"} <= names
