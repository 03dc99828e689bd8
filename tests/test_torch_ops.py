"""Port parity: the public compute ops (qserve_tpu_torch.kernels.ops) on
CPU tensors, i.e. their plain versions, against qserve_tpu.kernels.ops'
XLA fallbacks; and the kernel wrappers' refusal of what they cannot take."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import ops as jops
from qserve_tpu.layers import linear as jlin
from qserve_tpu_torch.kernels import ops as tops
from torch_port_util import bf16_ulps, to_np, to_torch


def _bf16_pair(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return xt, jnp.asarray(to_np(xt)).astype(jnp.bfloat16)


def _assert_quant_close(got, want):
    """Through RMSNorm or SiLU the two sides may round y an ulp apart: at
    most 0.1% of codes off by one, scales within rel 1e-6."""
    qg, sg, ag = (to_np(t) if t is not None else None for t in got)
    qw, sw, aw = (np.asarray(t) if t is not None else None for t in want)
    diff = np.abs(qg.astype(np.int32) - qw.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(sg, sw, rtol=1e-6)
    if aw is None:
        assert ag is None
    else:
        np.testing.assert_allclose(ag, aw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_sum", [False, True])
def test_quant_per_token_identical_codes(with_sum):
    xt, xj = _bf16_pair((24, 512), 0)
    got = tops.quant_per_token(xt, with_sum)
    want = jops.quant_per_token(xj, with_sum)
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    if with_sum:
        np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))


def test_rmsnorm_quant():
    xt, xj = _bf16_pair((24, 512), 1)
    w = (1.0 + 0.1 * np.random.default_rng(2).standard_normal(512)).astype(np.float32)
    got = tops.rmsnorm_quant(xt, torch.from_numpy(w), 1e-5, True)
    want = jops.rmsnorm_quant(xj, jnp.asarray(w), 1e-5, True)
    _assert_quant_close(got, want)


def test_add_rmsnorm_quant():
    ht, hj = _bf16_pair((24, 512), 3)
    dt, dj = _bf16_pair((24, 512), 4)
    w = (1.0 + 0.1 * np.random.default_rng(5).standard_normal(512)).astype(np.float32)
    h_new, *got = tops.add_rmsnorm_quant(ht, dt, torch.from_numpy(w), 1e-5, True)
    jh_new, *want = jops.add_rmsnorm_quant(hj, dj, jnp.asarray(w), 1e-5, True)
    np.testing.assert_array_equal(to_np(h_new), np.asarray(jh_new, np.float32))
    _assert_quant_close(got, want)


@pytest.mark.parametrize("with_sum", [False, True])
def test_silu_mul_quant(with_sum):
    gt, gj = _bf16_pair((16, 2 * 384), 6, scale=2.0)
    _assert_quant_close(
        tops.silu_mul_quant(gt, with_sum), jops.silu_mul_quant(gj, with_sum)
    )


def test_rmsnorm_and_silu_mul_within_one_ulp():
    xt, xj = _bf16_pair((8, 256), 7)
    w = np.linspace(0.5, 1.5, 256).astype(np.float32)
    got = tops.rmsnorm(xt, torch.from_numpy(w), 1e-6)
    want = to_torch(jops.rmsnorm(xj, jnp.asarray(w), 1e-6))
    assert bf16_ulps(got, want) <= 1
    got = tops.silu_mul(xt)
    want = to_torch(jops.silu_mul(xj))
    assert bf16_ulps(got, want) <= 1


@pytest.mark.parametrize("M", [1, 5, 64])
def test_w4a8_gemm_per_chn_within_one_ulp(M):
    r = np.random.default_rng(8)
    w = (r.standard_normal((256, 192)) * 0.05).astype(np.float32)
    p = jlin.quantize_linear_from_float(jnp.asarray(w), 4, -1)
    xt, xj = _bf16_pair((M, 256), 9)
    qj, sj, aj = jops.quant_per_token(xj, True)
    want = jops.w4a8_gemm_per_chn(qj, sj, aj, p.qweight, p.s1_scale, p.s1_szero)
    got = tops.w4a8_gemm_per_chn(*map(to_torch, (qj, sj, aj, *p)))
    assert got.dtype == torch.bfloat16
    assert bf16_ulps(got, to_torch(want)) <= 1


def test_lm_head_matmul_f32_logits():
    xt, xj = _bf16_pair((4, 128), 10)
    wt, wj = _bf16_pair((128, 96), 11, scale=0.05)
    got = tops.matmul(xt, wt, torch.float32)
    want = jops.matmul(xj, wj, jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def _wrapper_calls():
    """Each kernel wrapper called with CPU tensors of otherwise valid
    shapes: a wrapper launches or raises, it never computes on the CPU."""
    from qserve_tpu_torch.kernels import (
        elementwise, flash_attention, gemm, kv_append, paged_attention,
    )

    bf = dict(dtype=torch.bfloat16)
    i8, i32, f32 = torch.int8, torch.int32, torch.float32
    return {
        "elementwise": lambda: elementwise.launch(
            elementwise.MODE_QUANT, torch.zeros(4, 128, **bf)),
        "w4a8_gemm_per_chn": lambda: gemm.w4a8_gemm_per_chn(
            torch.zeros(4, 128, dtype=i8), torch.ones(4, 1), torch.zeros(4, 1),
            torch.zeros(64, 64, dtype=i8), torch.ones(64), torch.zeros(64)),
        "flash_prefill_attention": lambda: flash_attention.flash_prefill_attention(
            torch.zeros(16, 4, 64, **bf), torch.zeros(16, 2, 64, **bf),
            torch.zeros(16, 2, 64, **bf), torch.ones(16, dtype=i32), 0.125),
        "paged_decode_attention": lambda: paged_attention.paged_decode_attention(
            torch.zeros(2, 4, 64, **bf), torch.zeros(3, 2, 16, 64, dtype=i8),
            torch.zeros(3, 2, 4, 16, dtype=f32), torch.zeros(2, 3, dtype=i32),
            torch.ones(2, dtype=i32), torch.zeros(2, 2, 64, **bf),
            torch.zeros(2, 2, 64, **bf), 0.125),
        "kv_append": lambda: kv_append.kv_append(
            torch.zeros(1, 3, 2, 16, 64, dtype=i8),
            torch.zeros(1, 3, 2, 4, 16, dtype=f32),
            torch.zeros(1, 2, 2, 64, dtype=i8), torch.zeros(1, 2, 2, 4, dtype=f32),
            torch.zeros(2, dtype=i32), torch.zeros(2, dtype=i32)),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrapper_refuses_cpu_tensors(name):
    from qserve_tpu_torch.kernels import _build

    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _wrapper_calls()[name]()
    assert dict(_build.LAUNCHES) == before
