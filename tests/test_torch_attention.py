"""Port parity: prefill and paged-decode attention (the plain versions the
CUDA kernels are held to) against qserve_tpu.kernels.attention's XLA
fallbacks, within atol 2e-2 in bf16, padding rows and ctx == 0 rows
included. The tolerance covers bf16 output rounding plus the two sides'
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
    cache = tkvc.create_kv_cache(L, P, H, ps, D, 4, device="cpu")
    r = np.random.default_rng(H)
    # a filled cache: every byte a valid pair of nibbles, positive scales
    cache.data.copy_(torch.from_numpy(r.integers(-128, 128, cache.data.shape)
                                      .astype(np.int8)))
    sc = r.random(cache.scales.shape).astype(np.float32) * 0.2
    sc[:, :, :, H:, :] -= 1.5  # the zero rows: offsets around -1.5
    cache.scales.copy_(torch.from_numpy(sc))
    jcache = jkvc.KVCache(
        jnp.asarray(cache.data.numpy()),
        jnp.asarray(to_np(cache.scales)).astype(
            jnp.bfloat16 if H == 8 else jnp.float32),
    )
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
