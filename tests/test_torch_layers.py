"""Port parity: RoPE, the sampler's top-k/top-p kept sets, the host
marshal and the cache engine's page copies and swaps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu import native as jnative
from qserve_tpu.layers import rope as jrope
from qserve_tpu.layers import sampler as jsampler
from qserve_tpu_torch import native as tnative
from qserve_tpu_torch.config import CacheConfig, QuantSpec
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
