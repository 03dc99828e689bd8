"""Port parity: prefill, prefix-prefill (chunk) and paged-decode attention
over KV4 and KV8 pages (the plain versions the CUDA kernels are held to)
against
qserve_tpu.kernels.attention's XLA fallbacks (on the CPU the JAX ops do not
dispatch to their Pallas kernels), within atol 2e-2 in bf16, padding rows
and ctx == 0 rows included. The tolerance covers bf16 output rounding plus the two sides'
different f32 summation orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import attention as jattn
from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu_torch.kernels import attention as tattn
from qserve_tpu_torch.kernels import kv_cache as tkvc
from torch_port_util import to_np

ATOL = 2e-2


def _bf16(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return xt, jnp.asarray(to_np(xt)).astype(jnp.bfloat16)


def _filled_cache(L, P, H, ps, D, seed, kv_bits=4):
    """A cache whose every byte is a valid pair of nibbles (KV4) or a valid
    code u - 128 (KV8), with positive scales and zeros around -1.5, on both
    sides."""
    cache = tkvc.create_kv_cache(L, P, H, ps, D, kv_bits, device="cpu")
    r = np.random.default_rng(seed)
    cache.data.copy_(torch.from_numpy(r.integers(-128, 128, cache.data.shape)
                                      .astype(np.int8)))
    # KV8 codes are 16 times larger: scale the scales down to match
    sc = r.random(cache.scales.shape).astype(np.float32) * (0.2 if kv_bits == 4 else 0.0125)
    sc[:, :, :, H:, :] -= 1.5
    cache.scales.copy_(torch.from_numpy(sc))
    jcache = jkvc.KVCache(
        jnp.asarray(cache.data.numpy()),
        jnp.asarray(to_np(cache.scales)).astype(
            jnp.bfloat16 if cache.scales.dtype == torch.bfloat16 else jnp.float32),
    )
    return cache, jcache


@pytest.mark.parametrize("window", [None, 5])
def test_prefill_attention(window):
    T, Hq, Hkv, D = 48, 4, 2, 32
    (qt, qj), (kt, kj), (vt, vj) = (_bf16((T, h, D), s) for s, h in
                                    ((0, Hq), (1, Hkv), (2, Hkv)))
    seg = np.array([1] * 20 + [2] * 9 + [3] * 13 + [0] * 6, np.int32)
    got = tattn.prefill_attention(qt, kt, vt, torch.from_numpy(seg),
                                  sliding_window=window)
    want = jattn.prefill_attention(qj, kj, vj, jnp.asarray(seg),
                                   sliding_window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (T, Hq, D)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=ATOL)


@pytest.mark.parametrize("H", [8, 2])  # bf16 and f32 scales
@pytest.mark.parametrize("window", [None, 7])
def test_paged_decode_attention(H, window):
    L, P, ps, D, rep = 2, 10, 16, 32, 2
    B, Hq = 5, H * rep
    cache, jcache = _filled_cache(L, P, H, ps, D, seed=H)
    bt = np.array([[3, 1, 7], [0, 2, 0], [5, 0, 0], [9, 8, 6], [0, 0, 0]], np.int32)
    ctx = np.array([40, 17, 1, 48, 0], np.int32)  # ctx 1: self only; 0: pad row
    (qt, qj), (kt, kj), (vt, vj) = (_bf16((B, h, D), s) for s, h in
                                    ((3, Hq), (4, H), (5, H)))
    for li in range(L):
        got = tattn.paged_decode_attention(
            qt, cache, torch.from_numpy(bt), torch.from_numpy(ctx), li, kt, vt, 4,
            sliding_window=window,
        )
        want = jattn.paged_decode_attention(
            qj, jcache, jnp.asarray(bt), jnp.asarray(ctx), li, kj, vj, 4,
            sliding_window=window,
        )
        out = to_np(got)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, np.asarray(want, np.float32), atol=ATOL)


@pytest.mark.parametrize("H,rep", [(8, 2), (2, 2), (4, 1)])  # rep 1: no GQA
@pytest.mark.parametrize("window", [None, 7])
def test_paged_decode_attention_kv8(H, rep, window):
    """KV8 pages: one byte u - 128 per value, a row H * D bytes wide."""
    L, P, ps, D = 2, 10, 16, 32
    B, Hq = 5, H * rep
    cache, jcache = _filled_cache(L, P, H, ps, D, seed=H, kv_bits=8)
    assert cache.data.shape[-1] == H * D
    bt = np.array([[3, 1, 7], [0, 2, 0], [5, 0, 0], [9, 8, 6], [0, 0, 0]], np.int32)
    ctx = np.array([40, 17, 1, 48, 0], np.int32)
    (qt, qj), (kt, kj), (vt, vj) = (_bf16((B, h, D), s) for s, h in
                                    ((3, Hq), (4, H), (5, H)))
    for li in range(L):
        got = tattn.paged_decode_attention(
            qt, cache, torch.from_numpy(bt), torch.from_numpy(ctx), li, kt, vt, 8,
            sliding_window=window,
        )
        want = jattn.paged_decode_attention(
            qj, jcache, jnp.asarray(bt), jnp.asarray(ctx), li, kj, vj, 8,
            sliding_window=window,
        )
        out = to_np(got)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, np.asarray(want, np.float32), atol=ATOL)


def _chunk(T, live, Hq, H, D, prefix_len):
    qkv = [_bf16((T, h, D), s) for s, h in ((6, Hq), (7, H), (8, H))]
    seg = np.zeros(T, np.int32)
    seg[:live] = 1
    pos = np.zeros(T, np.int32)
    pos[:live] = prefix_len + np.arange(live)
    return qkv, seg, pos


@pytest.mark.parametrize("H", [8, 2])  # bf16 and f32 scales
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("prefix_len", [0, 64, 97])
def test_prefix_prefill_attention(prefix_len, window, H):
    """A 41-token chunk (7 padding rows) over a cached prefix that ends on a
    page boundary, mid-page, or is empty. Live rows within ATOL; padding
    rows attend nothing and stay finite (neither side reads them)."""
    L, P, ps, D, rep, T, live = 2, 12, 16, 32, 2, 48, 41
    cache, jcache = _filled_cache(L, P, H, ps, D, seed=H + prefix_len)
    bt = np.zeros((1, 10), np.int32)
    bt[0, :7] = [5, 0, 9, 3, 11, 7, 2]
    ((qt, qj), (kt, kj), (vt, vj)), seg, pos = _chunk(T, live, H * rep, H, D,
                                                      prefix_len)
    got = tattn.prefix_prefill_attention(
        qt, kt, vt, torch.from_numpy(seg), torch.from_numpy(pos), cache,
        torch.from_numpy(bt), prefix_len, 1, 4, sliding_window=window,
    )
    want = jattn.prefix_prefill_attention(
        qj, kj, vj, jnp.asarray(seg), jnp.asarray(pos), jcache, jnp.asarray(bt),
        jnp.int32(prefix_len), jnp.int32(1), 4, sliding_window=window,
    )
    out = to_np(got)
    assert got.dtype == torch.bfloat16 and out.shape == (T, H * rep, D)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[:live], np.asarray(want, np.float32)[:live],
                               atol=ATOL)


@pytest.mark.parametrize("H,rep", [(8, 2), (2, 2), (4, 1)])  # rep 1: no GQA
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("prefix_len", [64, 97])
def test_prefix_prefill_attention_kv8(prefix_len, window, H, rep):
    """The chunk op over KV8 prefix pages."""
    L, P, ps, D, T, live = 2, 12, 16, 32, 48, 41
    cache, jcache = _filled_cache(L, P, H, ps, D, seed=H + prefix_len, kv_bits=8)
    bt = np.zeros((1, 10), np.int32)
    bt[0, :7] = [5, 0, 9, 3, 11, 7, 2]
    ((qt, qj), (kt, kj), (vt, vj)), seg, pos = _chunk(T, live, H * rep, H, D,
                                                      prefix_len)
    got = tattn.prefix_prefill_attention(
        qt, kt, vt, torch.from_numpy(seg), torch.from_numpy(pos), cache,
        torch.from_numpy(bt), prefix_len, 1, 8, sliding_window=window,
    )
    want = jattn.prefix_prefill_attention(
        qj, kj, vj, jnp.asarray(seg), jnp.asarray(pos), jcache, jnp.asarray(bt),
        jnp.int32(prefix_len), jnp.int32(1), 8, sliding_window=window,
    )
    out = to_np(got)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[:live], np.asarray(want, np.float32)[:live],
                               atol=ATOL)


@pytest.mark.parametrize("window", [None, 9])
def test_prefix_prefill_without_prefix_is_prefill(window):
    """prefix_len 0: the chunk op is the packed prefill op on one segment."""
    H, rep, D, T, live = 2, 2, 32, 48, 41
    cache, _ = _filled_cache(1, 4, H, 16, D, seed=0)
    ((qt, _), (kt, _), (vt, _)), seg, pos = _chunk(T, live, H * rep, H, D, 0)
    seg_t = torch.from_numpy(seg)
    got = tattn.prefix_prefill_attention(
        qt, kt, vt, seg_t, torch.from_numpy(pos), cache,
        torch.zeros((1, 4), dtype=torch.int32), 0, 0, 4, sliding_window=window,
    )
    want = tattn.prefill_attention(qt, kt, vt, seg_t, sliding_window=window)
    np.testing.assert_allclose(to_np(got)[:live], to_np(want)[:live], atol=ATOL)


def test_prefix_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version in its place."""
    from qserve_tpu_torch.kernels import prefix_attention as kprefix

    cache, _ = _filled_cache(1, 4, 2, 16, 64, seed=1)
    ((q, _), (k, _), (v, _)), seg, pos = _chunk(16, 10, 4, 2, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kprefix.prefix_prefill_attention(
            q, k, v, torch.from_numpy(seg), torch.from_numpy(pos), cache.data[0],
            cache.scales[0], torch.zeros(4, dtype=torch.int32), 16, 0.125)
