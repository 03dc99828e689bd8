"""Roofline and MFU counts of the model families against shapes worked by
hand."""

import pytest

from qbench import registry
from qbench.harness import Step
from qbench.roofline import gemm, model, paged_attention, peaks

MISTRAL = "mistral-7b-v0.1.w4a8kv4"
MIXTRAL = "mixtral-8x7b-v0.1.w4a8kv4"


def _family(name):
    cfg = registry.load_json(f"{registry.QBENCH}/configs/{name}.json")
    fam = registry.family_of(cfg)
    return fam, fam.sizes(cfg)


def _step(spans=(), ctx=(), rows=0):
    return Step(0.0, 1.0, "x", 0, list(ctx), list(spans), rows, 0, 0)


def test_w4a8_gemm_counts():
    # gate_up at M = 64: weight 4096 x 28672 / 2, two f32 vectors, acts, out
    assert gemm.w4a8_bytes(64, 4096, 28672) == (
        4096 * 28672 // 2 + 2 * 28672 * 4 + 64 * 4096 + 2 * 64 * 4 + 64 * 28672 * 2)
    assert gemm.w4a8_ops(64, 4096, 28672) == 2 * 64 * 4096 * 28672


def test_gemm_step_bound_dense_decode():
    fam, sz = _family(MISTRAL)
    st = _step(ctx=[100] * 128)
    want = 0.0
    for k, n in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)):
        b = k * n / 2 + 8 * n + 128 * k + 8 * 128 + 128 * n * 2
        want += max(b / 3.35e12, 2 * 128 * k * n / 1979e12)
    assert fam.gemm_bound_s(st, sz) == pytest.approx(32 * want)


def test_gemm_step_bound_moe_counts_routed_rows_only():
    fam, sz = _family(MIXTRAL)
    one = fam.gemm_bound_s(_step(ctx=[10]), sz)
    # one decode row: 2 routed rows, about 2 experts' weights (1 - (6/8)^1)
    used = 8 * (1 - 0.75)
    assert used == pytest.approx(2.0)
    attn = sum(peaks.bound_s(gemm.w4a8_bytes(1, k, n), gemm.w4a8_ops(1, k, n))
               for k, n in ((4096, 6144), (4096, 4096)))
    mlp = (peaks.bound_s(gemm.w4a8_bytes(2, 4096, 28672, 2.0), gemm.w4a8_ops(2, 4096, 28672))
           + peaks.bound_s(gemm.w4a8_bytes(2, 14336, 4096, 2.0), gemm.w4a8_ops(2, 14336, 4096)))
    assert one == pytest.approx(32 * (attn + mlp))
    # a long stream reads every expert: near 8 experts' bytes, ops of 2 rows a token
    assert gemm.expected_experts(2048, 8, 2) == pytest.approx(8.0)


def test_paged_row_bytes_by_hand():
    fam, sz = _family(MISTRAL)
    ctx = 1000  # 999 cached tokens, 8 kv heads, D 128, KV4, bf16 scale and zero
    want = (2 * 999 * 8 * 128 * 0.5 + 2 * 999 * 8 * 2 * 2 + 2 * 8 * 128 * 2
            + 2 * 32 * 128 * 2 + 4 * 4)
    assert paged_attention.row_bytes(ctx, sz) == pytest.approx(want)
    st = _step(ctx=[ctx, ctx])
    assert fam.paged_attn_bound_s(st, sz) == pytest.approx(32 * 2 * want / 3.35e12)


def test_model_ops_by_hand():
    fam, sz = _family(MISTRAL)
    per_tok = 4096 * 6144 + 4096 * 4096 + 4096 * 28672 + 14336 * 4096
    assert fam.params_per_token_layer(sz) == per_tok
    # a 3-token prompt from 0 (contexts 1, 2, 3) and one decode row at context 10
    st = _step(spans=[(0, 3)], ctx=[10], rows=2)
    want = (2 * 4 * 32 * per_tok + 2 * 2 * 4096 * 32000 + 4 * 32 * 128 * (1 + 2 + 3 + 10) * 32)
    assert fam.step_ops(st, sz) == pytest.approx(want)
    mfam, mx = _family(MIXTRAL)
    assert mfam.params_per_token_layer(mx) == (
        4096 * 6144 + 4096 * 4096 + 4096 * 8 + 2 * (4096 * 28672 + 14336 * 4096))


def test_window_caps_context():
    assert model.ctx_sum(0, 3, None) == 6
    assert model.ctx_sum(0, 6, 4) == 1 + 2 + 3 + 4 + 4 + 4
    assert model.ctx_sum(5, 7, 4) == 8
    assert model.ctx_sum(2, 5, 4) == 3 + 4 + 4
