"""Port parity: W4/KV4 packing and QoQ quantization math (per-channel and
per-group W4, W8, activations, KV), bit-exact against qserve_tpu.quant (the
oracles every kernel of the port is held to)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.quant import packing as jpack
from qserve_tpu.quant import qoq as jqoq
from qserve_tpu_torch.quant import packing as tpack
from qserve_tpu_torch.quant import qoq as tqoq
from torch_port_util import to_np, to_torch


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_pack_w4_bitexact_and_roundtrip():
    q = _rng().integers(0, 16, (64, 48)).astype(np.int8)
    jp = np.asarray(jpack.pack_w4(jnp.asarray(q)))
    tp = tpack.pack_w4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tpack.unpack_w4(tp).numpy(), q)
    stacked = np.stack([jp, jp[::-1]])  # [L, K/2, N]
    np.testing.assert_array_equal(
        tpack.unpack_w4(torch.from_numpy(stacked.copy())).numpy(),
        np.asarray(jpack.unpack_w4(jnp.asarray(stacked))),
    )


def test_pack_kv4_bitexact_and_roundtrip():
    q = _rng(1).integers(0, 16, (3, 5, 2, 32)).astype(np.int32)
    jp = np.asarray(jpack.pack_kv4(jnp.asarray(q)))
    tp = tpack.pack_kv4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tpack.unpack_kv4(tp).numpy(), q)


@pytest.mark.parametrize("with_sum", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_per_token_bitexact(with_sum, dtype):
    x = (_rng(2).standard_normal((17, 256)) * 3).astype(np.float32)
    x[3, :] = 0.0  # all-zero row: the 1e-8 scale floor
    x[4, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # exact half points (RNE)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(to_np(xt)).astype(getattr(jnp, dtype))
    qj, sj, aj = jqoq.quantize_activation_per_token(xj, with_sum)
    qt, st, at = tqoq.quantize_activation_per_token(xt, with_sum)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if with_sum:
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    else:
        assert at is None and aj is None


def test_quantize_weight_per_channel_bitexact():
    w = (_rng(3).standard_normal((128, 96)) * 0.05).astype(np.float32)
    pj = jqoq.quantize_weight_per_channel(jnp.asarray(w))
    pt = tqoq.quantize_weight_per_channel(torch.from_numpy(w))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("asymmetric", [True, False])
def test_quantize_kv_bitexact(bits, asymmetric):
    x = _rng(4).standard_normal((6, 2, 32)).astype(np.float32)
    qj, sj, zj = jqoq.quantize_kv(jnp.asarray(x), bits, asymmetric)
    qt, st, zt = tqoq.quantize_kv(torch.from_numpy(x), bits, asymmetric)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(
        tqoq.dequantize_kv(qt, st, zt).numpy(),
        np.asarray(jqoq.dequantize_kv(qj, sj, zj)),
    )


def test_reference_gemm_int32_sums_bitexact():
    """The integer part of the per-channel W4A8 GEMM: int8 x uint4 -> int32."""
    r = _rng(5)
    a = r.integers(-128, 128, (9, 512)).astype(np.int8)
    w = r.integers(0, 16, (512, 64)).astype(np.int8)
    want = jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    got = tqoq.int_matmul(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reference_gemm_output():
    """The full reference epilogue, (psum*s1)*a_scale - s1_szero*a_sum, in
    bf16: equal bits (both evaluate the same f32 expression in order)."""
    r = _rng(6)
    w = (r.standard_normal((256, 64)) * 0.05).astype(np.float32)
    x = r.standard_normal((7, 256)).astype(np.float32)
    pj = jqoq.quantize_weight_per_channel(jnp.asarray(w))
    qj, sj, aj = jqoq.quantize_activation_per_token(jnp.asarray(x), True)
    want = jqoq.w4a8_gemm_per_channel_ref(qj, sj, aj, pj)
    pt = tqoq.PerChannelW4(*(to_torch(t) for t in pj))
    got = tqoq.w4a8_gemm_per_channel_ref(to_torch(qj), to_torch(sj), to_torch(aj), pt)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("K,N,G", [(512, 96, 128), (768, 64, 128), (256, 48, 64)])
def test_quantize_weight_per_group_bitexact(K, N, G):
    """Two-level quantizer: qweight, s2_scale (uint8 in an int8 carrier),
    s2_zero and s1_scale equal the JAX package's, as do the level-2 int8
    reconstruction and the float one. One column spans the whole int8 range
    inside a group, which drives s2 against its 15 * s2 + z2 <= 127 clamp."""
    w = (_rng(7).standard_normal((K, N)) * 0.05).astype(np.float32)
    w[:G, 0] = np.linspace(-1.0, 1.0, G)
    pj = jqoq.quantize_weight_per_group(jnp.asarray(w), G)
    pt = tqoq.quantize_weight_per_group(torch.from_numpy(w), G)
    for name, a, b in zip(pj._fields, pt, pj):
        assert a.dtype == getattr(torch, str(b.dtype)), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(
        tqoq.pergroup_level2_int8(pt, G).numpy(),
        np.asarray(jqoq.pergroup_level2_int8(pj, G)),
    )
    np.testing.assert_array_equal(
        tqoq.dequantize_per_group(pt, G).numpy(),
        np.asarray(jqoq.dequantize_per_group(pj, G)),
    )


def test_pergroup_level2_wraps_off_the_lattice_as_the_jax_cast():
    """Random bytes are not what the quantizer emits: q * s2 + z2 may leave
    int8. Both packages wrap it then (an int32 -> int8 cast)."""
    r = _rng(8)
    K, N, G = 256, 32, 128
    fields = (
        r.integers(0, 16, (K, N)).astype(np.int8),
        r.integers(-128, 128, (K // G, N)).astype(np.int8),
        r.integers(-128, 128, (K // G, N)).astype(np.int8),
        r.random(N).astype(np.float32),
    )
    want = jqoq.pergroup_level2_int8(jqoq.PerGroupW4(*map(jnp.asarray, fields)), G)
    got = tqoq.pergroup_level2_int8(
        tqoq.PerGroupW4(*(torch.from_numpy(f) for f in fields)), G)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_weight_w8_bitexact():
    w = (_rng(9).standard_normal((128, 96)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel: the 1e-8 scale floor
    pj = jqoq.quantize_weight_w8(jnp.asarray(w))
    pt = tqoq.quantize_weight_w8(torch.from_numpy(w))
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tqoq.dequantize_w8(pt).numpy(), np.asarray(jqoq.dequantize_w8(pj)))


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("flavor", ["per_group", "w8"])
def test_reference_gemm_output_per_group_and_w8(flavor, out):
    """The per-group and W8 reference GEMMs, (psum * scale) * a_scale: equal
    bits in bf16 and in f32."""
    r = _rng(10)
    w = (r.standard_normal((256, 64)) * 0.05).astype(np.float32)
    x = r.standard_normal((7, 256)).astype(np.float32)
    qj, sj, _ = jqoq.quantize_activation_per_token(jnp.asarray(x))
    if flavor == "per_group":
        pj = jqoq.quantize_weight_per_group(jnp.asarray(w), 128)
        want = jqoq.w4a8_gemm_per_group_ref(qj, sj, pj, 128, getattr(jnp, out))
        pt = tqoq.PerGroupW4(*(to_torch(t) for t in pj))
        got = tqoq.w4a8_gemm_per_group_ref(
            to_torch(qj), to_torch(sj), pt, 128, getattr(torch, out))
    else:
        pj = jqoq.quantize_weight_w8(jnp.asarray(w))
        want = jqoq.w8a8_gemm_ref(qj, sj, pj, getattr(jnp, out))
        pt = tqoq.W8(*(to_torch(t) for t in pj))
        got = tqoq.w8a8_gemm_ref(to_torch(qj), to_torch(sj), pt, getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
