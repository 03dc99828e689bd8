"""Port parity: the public compute ops (qserve_tpu_torch.kernels.ops) on
CPU tensors, i.e. their plain versions, against qserve_tpu.kernels.ops'
XLA fallbacks; and the kernel wrappers' refusal of what they cannot take."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import ops as jops
from qserve_tpu.kernels import pallas_gemm as jpg
from qserve_tpu.layers import linear as jlin
from qserve_tpu.quant import packing as jpack
from qserve_tpu.quant import qoq as jqoq
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


def _quant_act(M, K, seed):
    _, xj = _bf16_pair((M, K), seed)
    qj, sj, _ = jops.quant_per_token(xj, False)
    return qj, sj


# tiled: K/2 a multiple of 8 groups (the TPU's tiled kernel); ragged: 3
# groups a nibble plane (its whole-strip kernel; the small image of
# K = 11008's 43). The port has one function for both.
_GROUP_SHAPES = {"tiled": (2048, 128), "ragged": (768, 128), "g64": (384, 64)}


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("M", [1, 33])
@pytest.mark.parametrize("shape", sorted(_GROUP_SHAPES))
def test_w4a8_gemm_per_group_bitexact(shape, M, out):
    """Integer level-2 reconstruction and integer sums, then the same two
    f32 products in the same order: equal bits against qoq's reference."""
    K, G = _GROUP_SHAPES[shape]
    w = (np.random.default_rng(12).standard_normal((K, 192)) * 0.05).astype(np.float32)
    p = jlin.quantize_linear_from_float(jnp.asarray(w), 4, G)
    qj, sj = _quant_act(M, K, 13)
    ref = jqoq.PerGroupW4(jpack.unpack_w4(p.qweight), p.s2_scale, p.s2_zero,
                          p.s1_scale)
    want = jqoq.w4a8_gemm_per_group_ref(qj, sj, ref, G, getattr(jnp, out))
    got = tops.w4a8_gemm_per_group(
        *map(to_torch, (qj, sj, *p)), G, getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (M, 192)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
    # the dispatching op of the JAX package (its XLA path on the CPU)
    via_op = jops.w4a8_gemm_per_group(qj, sj, *p, G, getattr(jnp, out))
    np.testing.assert_array_equal(to_np(got), np.asarray(via_op, np.float32))


@pytest.mark.parametrize("shape", ["tiled", "ragged"])
def test_w4a8_gemm_per_group_against_pallas_interpret(shape):
    """The TPU kernels in interpret mode. They add the zero-point term as an
    f32 dot to the integer sums, so they may land an f32 ulp off: rtol 1e-6
    in f32 (plus an atol for sums near 0), one bf16 step in bf16."""
    K, G = _GROUP_SHAPES[shape]
    kernel = (jpg.w4a8_gemm_per_group_pallas if shape == "tiled"
              else jpg.w4a8_gemm_per_group_whole_pallas)
    w = (np.random.default_rng(14).standard_normal((K, 256)) * 0.05).astype(np.float32)
    p = jlin.quantize_linear_from_float(jnp.asarray(w), 4, G)
    qj, sj = _quant_act(16, K, 15)
    args_t = tuple(map(to_torch, (qj, sj, *p)))
    want = kernel(qj, sj, *p, G, jnp.float32)
    got = tops.w4a8_gemm_per_group(*args_t, G, torch.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = kernel(qj, sj, *p, G, jnp.bfloat16)
    got = tops.w4a8_gemm_per_group(*args_t, G, torch.bfloat16)
    assert bf16_ulps(got, to_torch(want)) <= 1


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("M", [1, 33])
def test_w8a8_gemm_bitexact(M, out):
    w = (np.random.default_rng(16).standard_normal((320, 192)) * 0.05).astype(np.float32)
    p = jlin.quantize_linear_from_float(jnp.asarray(w), 8)
    qj, sj = _quant_act(M, 320, 17)
    want = jqoq.w8a8_gemm_ref(qj, sj, jqoq.W8(*p), getattr(jnp, out))
    got = tops.w8a8_gemm(*map(to_torch, (qj, sj, *p)), getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (M, 192)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
    via_op = jops.w8a8_gemm(qj, sj, *p, getattr(jnp, out))
    np.testing.assert_array_equal(to_np(got), np.asarray(via_op, np.float32))


def test_lm_head_matmul_f32_logits():
    xt, xj = _bf16_pair((4, 128), 10)
    wt, wj = _bf16_pair((128, 96), 11, scale=0.05)
    got = tops.matmul(xt, wt, torch.float32)
    want = jops.matmul(xj, wj, jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


# --- routed (grouped) MoE GEMMs ---------------------------------------------

# 6 blocks of 16 rows over 4 experts: uneven runs, an expert with no block
# (2), and an all-pad tail block that names the last expert, as the MoE
# dispatch's clamp does. The port takes block_expert [nb]; the JAX package
# the [nb, 1] block_idx of the same experts.
_BLOCK_EXPERT = np.array([0, 0, 1, 3, 3, 3], np.int32)
_ROUTED = {
    "per_chn": (256, 4, -1),
    "per_group_tiled": (2048, 4, 128),
    "per_group_ragged": (768, 4, 128),
    "w8": (320, 8, -1),
}


def _routed_case(flavor, seed):
    """(JAX stacked experts, q, scale, act-sum) of one routed stream whose
    last 20 rows are padding (q = 0, scale 0, sum 0)."""
    import jax

    K, wbits, G = _ROUTED[flavor]
    NE, N, M = 4, 192, 16 * len(_BLOCK_EXPERT)
    r = np.random.default_rng(seed)
    experts = [
        jlin.quantize_linear_from_float(
            jnp.asarray((r.standard_normal((K, N)) * 0.05).astype(np.float32)), wbits, G)
        for _ in range(NE)
    ]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *experts)
    _, xj = _bf16_pair((M, K), seed + 1)
    qj, sj, aj = jops.quant_per_token(xj, True)
    live = (np.arange(M) < M - 20)[:, None]
    return (stacked, jnp.where(live, qj, 0).astype(jnp.int8),
            jnp.where(live, sj, 0.0), jnp.where(live, aj, 0.0))


@pytest.mark.parametrize("flavor", sorted(_ROUTED))
def test_routed_gemm_plain_bitexact(flavor):
    """Each block through its own expert: the plain versions equal the JAX
    package's routed XLA fallbacks bit for bit, pad rows exactly 0."""
    stacked, qj, sj, aj = _routed_case(flavor, 20)
    G = _ROUTED[flavor][2]
    be_j = jnp.asarray(_BLOCK_EXPERT)[:, None]
    be_t = torch.from_numpy(_BLOCK_EXPERT)
    if flavor == "per_chn":
        want = jops.w4a8_gemm_per_chn_routed(qj, sj, aj, *stacked, be_j)
        got = tops.w4a8_gemm_per_chn_routed(*map(to_torch, (qj, sj, aj, *stacked)), be_t)
    elif flavor == "w8":
        want = jops.w8a8_gemm_routed(qj, sj, *stacked, be_j)
        got = tops.w8a8_gemm_routed(*map(to_torch, (qj, sj, *stacked)), be_t)
    else:
        want = jops.w4a8_gemm_per_group_routed(qj, sj, *stacked, be_j, G)
        got = tops.w4a8_gemm_per_group_routed(*map(to_torch, (qj, sj, *stacked)), be_t, G)
    assert got.dtype == torch.bfloat16 and got.shape == (96, 192)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
    assert not got[-20:].any()


@pytest.mark.parametrize("flavor", ["per_chn", "per_group_ragged", "w8"])
def test_routed_gemm_plain_is_the_dense_plain_per_block(flavor):
    """A routed block is the dense plain GEMM of its expert on its rows."""
    stacked, qj, sj, aj = _routed_case(flavor, 21)
    G = _ROUTED[flavor][2]
    w = tuple(map(to_torch, stacked))
    q, sc, asum = map(to_torch, (qj, sj, aj))
    be = torch.from_numpy(_BLOCK_EXPERT)
    if flavor == "per_chn":
        got = tops.w4a8_gemm_per_chn_routed(q, sc, asum, *w, be)
        dense = lambda r, e: tops.w4a8_gemm_per_chn(q[r], sc[r], asum[r], *(x[e] for x in w))
    elif flavor == "w8":
        got = tops.w8a8_gemm_routed(q, sc, *w, be)
        dense = lambda r, e: tops.w8a8_gemm(q[r], sc[r], *(x[e] for x in w))
    else:
        got = tops.w4a8_gemm_per_group_routed(q, sc, *w, be, G)
        dense = lambda r, e: tops.w4a8_gemm_per_group(q[r], sc[r], *(x[e] for x in w), G)
    for b, e in enumerate(_BLOCK_EXPERT.tolist()):
        r = slice(16 * b, 16 * b + 16)
        assert torch.equal(got[r], dense(r, e)), f"block {b}"


def test_matmul_routed():
    """The W16A16 experts: f32 sums in another order than XLA's, rtol 1e-5."""
    r = np.random.default_rng(22)
    w = (r.standard_normal((4, 128, 96)) * 0.05).astype(np.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    wj = jnp.asarray(to_np(wt)).astype(jnp.bfloat16)
    xt, xj = _bf16_pair((96, 128), 23)
    want = jops.matmul_routed(xj, wj, jnp.asarray(_BLOCK_EXPERT)[:, None], jnp.float32)
    got = tops.matmul_routed(xt, wt, torch.from_numpy(_BLOCK_EXPERT), torch.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = tops.matmul_routed(xt, wt, torch.from_numpy(_BLOCK_EXPERT))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("flavor", ["per_chn", "per_group_tiled"])
def test_routed_gemm_against_pallas_interpret(flavor):
    """The TPU routed kernels in interpret mode on the same stream. Their
    epilogues round in other places (the per-group one adds its zero-point
    term as an f32 dot; the per-channel one's two products may fuse), so an
    output may land one bf16 step away, or 1e-5 where the two terms of the
    per-channel epilogue cancel to ~0."""
    from qserve_tpu.kernels import pallas_gemm as jpg

    stacked, qj, sj, aj = _routed_case(flavor, 24)
    be_j = jnp.asarray(_BLOCK_EXPERT)[:, None]
    be_t = torch.from_numpy(_BLOCK_EXPERT)
    if flavor == "per_chn":
        want = jpg.w4a8_gemm_per_chn_routed_pallas(qj, sj, aj, *stacked, be_j)
        got = tops.w4a8_gemm_per_chn_routed(*map(to_torch, (qj, sj, aj, *stacked)), be_t)
    else:
        want = jpg.w4a8_gemm_per_group_routed_pallas(qj, sj, *stacked, be_j, 128)
        got = tops.w4a8_gemm_per_group_routed(*map(to_torch, (qj, sj, *stacked)), be_t, 128)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=2.0**-8, atol=1e-5)


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
        "w4a8_gemm_per_group": lambda: gemm.w4a8_gemm_per_group(
            torch.zeros(4, 256, dtype=i8), torch.ones(4, 1),
            torch.zeros(128, 64, dtype=i8), torch.ones(2, 64, dtype=i8),
            torch.zeros(2, 64, dtype=i8), torch.ones(64)),
        "w8a8_gemm": lambda: gemm.w8a8_gemm(
            torch.zeros(4, 128, dtype=i8), torch.ones(4, 1),
            torch.zeros(128, 64, dtype=i8), torch.ones(64), torch.float32),
        "paged_decode_attention_kv8": lambda: paged_attention.paged_decode_attention(
            torch.zeros(2, 4, 64, **bf), torch.zeros(3, 2, 16, 128, dtype=i8),
            torch.zeros(3, 2, 4, 16, dtype=f32), torch.zeros(2, 3, dtype=i32),
            torch.ones(2, dtype=i32), torch.zeros(2, 2, 64, **bf),
            torch.zeros(2, 2, 64, **bf), 0.125),
        "flash_prefill_attention": lambda: flash_attention.flash_prefill_attention(
            torch.zeros(16, 4, 64, **bf), torch.zeros(16, 2, 64, **bf),
            torch.zeros(16, 2, 64, **bf), torch.ones(16, dtype=i32), 0.125),
        "paged_decode_attention": lambda: paged_attention.paged_decode_attention(
            torch.zeros(2, 4, 64, **bf), torch.zeros(3, 2, 16, 64, dtype=i8),
            torch.zeros(3, 2, 4, 16, dtype=f32), torch.zeros(2, 3, dtype=i32),
            torch.ones(2, dtype=i32), torch.zeros(2, 2, 64, **bf),
            torch.zeros(2, 2, 64, **bf), 0.125),
        "w4a8_gemm_per_chn_routed": lambda: gemm.w4a8_gemm_per_chn_routed(
            torch.zeros(256, 128, dtype=i8), torch.ones(256, 1), torch.zeros(256, 1),
            torch.zeros(4, 64, 64, dtype=i8), torch.ones(4, 64), torch.zeros(4, 64),
            torch.zeros(2, dtype=i32)),
        "w4a8_gemm_per_group_routed": lambda: gemm.w4a8_gemm_per_group_routed(
            torch.zeros(256, 256, dtype=i8), torch.ones(256, 1),
            torch.zeros(4, 128, 64, dtype=i8), torch.ones(4, 2, 64, dtype=i8),
            torch.zeros(4, 2, 64, dtype=i8), torch.ones(4, 64),
            torch.zeros(2, dtype=i32)),
        "w8a8_gemm_routed": lambda: gemm.w8a8_gemm_routed(
            torch.zeros(256, 128, dtype=i8), torch.ones(256, 1),
            torch.zeros(4, 128, 64, dtype=i8), torch.ones(4, 64),
            torch.zeros(2, dtype=i32)),
        "kv_append": lambda: kv_append.kv_append(
            torch.zeros(1, 3, 2, 16, 64, dtype=i8),
            torch.zeros(1, 3, 2, 4, 16, dtype=f32),
            torch.zeros(1, 2, 2, 64, **bf), torch.zeros(1, 2, 2, 64, **bf),
            torch.zeros(2, dtype=i32), torch.zeros(2, dtype=i32), 4, True),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrapper_refuses_cpu_tensors(name):
    from qserve_tpu_torch.kernels import _build

    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _wrapper_calls()[name]()
    assert dict(_build.LAUNCHES) == before


def test_per_group_wrapper_refuses_groups_it_cannot_tile():
    """A k step of the kernel is 32 packed rows of each nibble plane: the
    group size must be a multiple of 32 and divide K (a group may straddle
    the planes)."""
    from qserve_tpu_torch.kernels import gemm

    i8 = torch.int8
    for K, G in ((256, 48), (320, 128)):  # G % 32 != 0; K % G != 0
        with pytest.raises(ValueError, match="group_size"):
            gemm.w4a8_gemm_per_group(
                torch.zeros(4, K, dtype=i8), torch.ones(4, 1),
                torch.zeros(K // 2, 64, dtype=i8),
                torch.ones(max(K // G, 1), 64, dtype=i8),
                torch.zeros(max(K // G, 1), 64, dtype=i8), torch.ones(64), G)


@pytest.mark.parametrize("M,nb", [(96, 6), (128, 3), (128, 0)])
def test_routed_wrappers_refuse_blocks_they_cannot_tile(M, nb):
    """A routed block must be a whole number of the kernels' 128-row tiles
    (the CPU tests' 16-row blocks run only the plain versions)."""
    from qserve_tpu_torch.kernels import gemm

    i8, i32 = torch.int8, torch.int32
    with pytest.raises(ValueError, match="nb"):
        gemm.w8a8_gemm_routed(
            torch.zeros(M, 128, dtype=i8), torch.ones(M, 1),
            torch.zeros(4, 128, 64, dtype=i8), torch.ones(4, 64),
            torch.zeros(nb, dtype=i32))


def _routed_call(flavor, M, nb):
    """One routed wrapper on CPU tensors with M rows in nb blocks."""
    from qserve_tpu_torch.kernels import gemm

    i8, be = torch.int8, torch.zeros(nb, dtype=torch.int32)
    if flavor == "per_chn":
        return gemm.w4a8_gemm_per_chn_routed(
            torch.zeros(M, 128, dtype=i8), torch.ones(M, 1), torch.zeros(M, 1),
            torch.zeros(4, 64, 64, dtype=i8), torch.ones(4, 64), torch.zeros(4, 64), be)
    if flavor == "per_group":
        return gemm.w4a8_gemm_per_group_routed(
            torch.zeros(M, 256, dtype=i8), torch.ones(M, 1),
            torch.zeros(4, 128, 64, dtype=i8), torch.ones(4, 2, 64, dtype=i8),
            torch.zeros(4, 2, 64, dtype=i8), torch.ones(4, 64), be)
    return gemm.w8a8_gemm_routed(
        torch.zeros(M, 128, dtype=i8), torch.ones(M, 1),
        torch.zeros(4, 128, 64, dtype=i8), torch.ones(4, 64), be)


@pytest.mark.parametrize("flavor", ["per_chn", "per_group", "w8"])
@pytest.mark.parametrize("M,nb", [(128, 2), (192, 1), (256, 0)])
def test_routed_wrappers_refuse_blocks_of_less_than_their_tile(flavor, M, nb):
    """K2's, K8's and K9's routed forms run the 128-row wgmma tile: a 64-row
    block is refused before any tensor is looked at, and 128- and 256-row
    blocks pass the check (the CPU tensors are then refused as such)."""
    with pytest.raises(ValueError, match="% 128"):
        _routed_call(flavor, M, nb)
    for rows in (128, 256):
        with pytest.raises(ValueError, match="CUDA"):
            _routed_call(flavor, 2 * rows, 2)


@pytest.mark.parametrize("K,G", [(192, 64), (896, 128)])  # K/2 % G: 32, 64
def test_per_group_straddling_groups(K, G):
    """Groups that straddle the nibble planes (K/2 % G != 0; Qwen2-0.5B's
    hidden 896 at g128): the dense and routed wrappers' shape checks take
    them (the CPU tensors are then refused as such), and the plain version
    equals the JAX package's reference bit for bit."""
    from qserve_tpu_torch.kernels import gemm

    N, M, i8 = 64, 5, torch.int8
    with pytest.raises(ValueError, match="CUDA"):
        gemm.w4a8_gemm_per_group(
            torch.zeros(4, K, dtype=i8), torch.ones(4, 1),
            torch.zeros(K // 2, N, dtype=i8), torch.ones(K // G, N, dtype=i8),
            torch.zeros(K // G, N, dtype=i8), torch.ones(N), G)
    with pytest.raises(ValueError, match="CUDA"):
        gemm.w4a8_gemm_per_group_routed(
            torch.zeros(256, K, dtype=i8), torch.ones(256, 1),
            torch.zeros(2, K // 2, N, dtype=i8), torch.ones(2, K // G, N, dtype=i8),
            torch.zeros(2, K // G, N, dtype=i8), torch.ones(2, N),
            torch.zeros(2, dtype=torch.int32), G)
    w = (np.random.default_rng(K).standard_normal((K, N)) * 0.05).astype(np.float32)
    p = jlin.quantize_linear_from_float(jnp.asarray(w), 4, G)
    qj, sj = _quant_act(M, K, 14)
    ref = jqoq.PerGroupW4(jpack.unpack_w4(p.qweight), p.s2_scale, p.s2_zero,
                          p.s1_scale)
    want = jqoq.w4a8_gemm_per_group_ref(qj, sj, ref, G)
    got = tops.w4a8_gemm_per_group(*map(to_torch, (qj, sj, *p)), G)
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 numpy arrays (s: one selector or one a
    lane): byte i of the result is byte (s >> 4i) & 7 of y:x."""
    xy = (x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32)))
    s = np.broadcast_to(np.asarray(s, np.uint64), xy.shape)
    out = np.zeros(xy.shape, np.uint64)
    for i in range(4):
        sel = (s >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((xy >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _quad():
    """gemm_common.cuh's Quad for all 256 threads: (rq, cq, f, rot)."""
    t = np.arange(256)
    warp, lane = t >> 5, t & 31
    rq = (lane >> 3) + 4 * (warp & 1)
    cq = ((warp >> 1) * 4 + ((lane >> 1) & 3)) * 2 + (lane & 1)
    f = (lane >> 1) & 3
    rot = (f & 3) | (((f + 1) & 3) << 4) | (((f + 2) & 3) << 8) | (((f + 3) & 3) << 12)
    return rq, cq, f, rot.astype(np.uint32)


def _transpose(slab, quad):
    """Quad::transpose: uint8 [32, 128] -> col[jj], uint32 [256] each."""
    rq, cq, _, rot = quad
    words = slab.reshape(32, 32, 4).copy().view(np.uint32)[..., 0]  # [row, word]
    x = [_byte_perm(words[4 * rq + i, cq], np.zeros(256, np.uint32), rot)
         for i in range(4)]
    t01l, t01h = _byte_perm(x[0], x[1], 0x5140), _byte_perm(x[0], x[1], 0x7362)
    t23l, t23h = _byte_perm(x[2], x[3], 0x5140), _byte_perm(x[2], x[3], 0x7362)
    return [_byte_perm(t01l, t23l, 0x5410), _byte_perm(t01l, t23l, 0x7632),
            _byte_perm(t01h, t23h, 0x5410), _byte_perm(t01h, t23h, 0x7632)]


def _kmajor(r, k):
    return (r >> 3) * 512 + (k >> 4) * 128 + (r & 7) * 16 + (k & 15)


def _store_tile(quad, words):
    """The stores of a convert: words[h][jj] (uint32 [256]) to Quad::offset(jj)
    + 256 h of the K-major tile, in its no-swizzle layout; returned as
    [128 n][64 k] bytes."""
    rq, cq, f, _ = quad
    bs = np.zeros(128 * 64, np.uint8)
    seen = np.zeros(128 * 64 // 4, np.int32)
    for jj in range(4):
        o = _kmajor(4 * cq + ((jj + f) & 3), 4 * rq)
        for h, half in enumerate(words):
            off = o + 256 * h
            # a warp's 32 stores land on 32 distinct banks
            banks = (off // 4) % 32
            assert all(len(set(banks[w * 32:(w + 1) * 32])) == 32 for w in range(8))
            bs.view(np.uint32)[off // 4] = half[jj]
            np.add.at(seen, off // 4, 1)
    assert (seen == 1).all()  # every word of the tile written once
    n, k = np.meshgrid(np.arange(128), np.arange(64), indexing="ij")
    return bs[_kmajor(n, k)]


def k2_stage_unpack(wtile):
    """csrc/w4a8_gemm.cu's StageW4::convert, all 256 threads at once: one
    step's packed rows uint8 [32, 128] -> the K-major tile wgmma reads, as
    [128 n][64 k]."""
    quad = _quad()
    col = _transpose(wtile, quad)
    return _store_tile(quad, ([c & 0x0F0F0F0F for c in col],
                              [(c >> 4) & 0x0F0F0F0F for c in col]))


def k9_stage_transpose(wtile):
    """csrc/w8a8_gemm.cu's StageW8::convert: one step's rows uint8 [64, 128]
    -> the K-major tile, [128 n][64 k]."""
    quad = _quad()
    return _store_tile(quad, [_transpose(wtile[32 * h:32 * h + 32], quad) for h in (0, 1)])


def k8_stage_level2(packed, s2, z2, G):
    """csrc/w4a8_gemm_per_group.cu's StageW4Group over a whole [K/2, 128]
    column tile, all 256 threads at once: K2's transpose, the per-word
    (s2, z2) reconstruction and the per-plane group counters, each group's
    words loaded one step ahead of their use. Returns W8 uint8 [K, 128]
    from the K-major tiles."""
    quad = _quad()
    _, cq, f, _ = quad
    K2 = packed.shape[0]
    K = 2 * K2
    s2w = s2.copy().view(np.uint32)  # [K/G, 32]: thread cq's 4 columns
    z2w = z2.copy().view(np.uint32)
    c = ((np.arange(4)[:, None] + f) & 3).astype(np.uint32)  # [jj, thread]
    sel_s, sel_z = 0x4440 | c, 0x4040 | c | (c << 8)
    st = dict(lo_g=0, hi_g=K2 // G, lo_next=0, hi_next=0)

    def load(s):
        r0 = 32 * s
        if r0 == st["lo_next"]:
            st["s2lo"], st["z2lo"] = s2w[st["lo_g"], cq], z2w[st["lo_g"], cq]
            st["lo_g"] += 1
            st["lo_next"] += G
        if r0 == st["hi_next"]:
            st["s2hi"], st["z2hi"] = s2w[st["hi_g"], cq], z2w[st["hi_g"], cq]
            st["hi_g"] += 1
            st["hi_next"] = st["hi_g"] * G - K2

    def level2(even, odd, s, zz):
        return _byte_perm(even * s + zz, odd * s + zz, 0x6240)

    zero = np.zeros(256, np.uint32)
    w8 = np.zeros((K, 128), np.uint8)
    load(0)
    for s in range(K // 64):
        col = _transpose(packed[32 * s:32 * s + 32], quad)
        halves = ([], [])
        for jj, w in enumerate(col):
            for h, (plane, shift) in enumerate((("lo", 0), ("hi", 4))):
                sc = _byte_perm(st["s2" + plane], zero, sel_s[jj])
                zz = _byte_perm(st["z2" + plane], zero, sel_z[jj])
                halves[h].append(level2((w >> shift) & 0x000F000F,
                                        (w >> (shift + 8)) & 0x000F000F, sc, zz))
        if s + 1 < K // 64:
            load(s + 1)
        tile = _store_tile(quad, halves)
        w8[32 * s:32 * s + 32] = tile[:, :32].T
        w8[K2 + 32 * s:K2 + 32 * s + 32] = tile[:, 32:].T
    return w8


def test_k2_stage_unpack_is_the_half_split_unpack():
    """K2's byte transpose and nibble split over random bytes: column n of
    the tile holds Wq[s*32 + k, n] for k < 32 and Wq[K/2 + s*32 + k - 32, n]
    above, as the JAX package's quant/packing unpack gives them."""
    K, N = 256, 128
    packed = np.random.default_rng(5).integers(-128, 128, (K // 2, N)).astype(np.int8)
    wq = np.asarray(jpack.unpack_w4(jnp.asarray(packed)))  # [K, N]
    for s in range(K // 64):
        tile = k2_stage_unpack(packed[s * 32:(s + 1) * 32].view(np.uint8))
        want = np.concatenate([wq[s * 32:(s + 1) * 32], wq[K // 2 + s * 32:K // 2 + (s + 1) * 32]])
        np.testing.assert_array_equal(tile, want.T.astype(np.uint8))


def test_k9_stage_transpose_is_the_weight():
    """K9's 64-row transpose over random bytes: column n of step s's tile
    holds W[s*64 + k, n], W the [K, N] weight as the JAX package stores it."""
    K, N = 256, 128
    w = np.random.default_rng(6).integers(-128, 128, (K, N)).astype(np.int8)
    for s in range(K // 64):
        tile = k9_stage_transpose(w[s * 64:(s + 1) * 64].view(np.uint8))
        np.testing.assert_array_equal(tile, w[s * 64:(s + 1) * 64].T.view(np.uint8))


# (K, G): tiled (2 groups a nibble plane); Llama-2-7B's K = 11008 at g128
# scaled down to g32 with the same 43 groups a plane; Qwen2-0.5B's hidden
# 896 at g128 (K/2 = 448: group 3 straddles the planes)
_K8_STAGE = {"tiled": (512, 128), "ragged": (2752, 32), "straddling": (896, 128)}


@pytest.mark.parametrize("bytes_", ["quantizer", "random"])
@pytest.mark.parametrize("shape", sorted(_K8_STAGE))
def test_k8_stage_level2_is_the_level2_reconstruction(shape, bytes_):
    """K8's transpose, per-word reconstruction and group counters give
    int8(q * s2 + z2) of the JAX package's qoq.pergroup_level2_int8 of its
    unpack, on the quantizer's lattice and off it (random bytes: s2 up to
    255, sums that wrap mod 256)."""
    K, G = _K8_STAGE[shape]
    N = 128
    r = np.random.default_rng(K + G)
    if bytes_ == "quantizer":
        w = jnp.asarray((r.standard_normal((K, N)) * 0.05).astype(np.float32))
        p = jlin.quantize_linear_from_float(w, 4, G)
        packed, s2, z2 = (np.asarray(x) for x in (p.qweight, p.s2_scale, p.s2_zero))
    else:
        packed, s2, z2 = (r.integers(-128, 128, sh).astype(np.int8)
                          for sh in ((K // 2, N), (K // G, N), (K // G, N)))
    want = jqoq.pergroup_level2_int8(
        jqoq.PerGroupW4(jpack.unpack_w4(jnp.asarray(packed)), jnp.asarray(s2),
                        jnp.asarray(z2), jnp.ones(N)), G)
    got = k8_stage_level2(packed.view(np.uint8), s2.view(np.uint8), z2.view(np.uint8), G)
    np.testing.assert_array_equal(got.view(np.int8), np.asarray(want))
