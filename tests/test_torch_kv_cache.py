"""Port parity: the paged KV4 cache. With identical k/v in, the port's
cache is byte-identical to the JAX package's after a prefill append and
after decode appends, for bf16 and f32 scales. The JAX side runs its XLA
scatter path (what it runs on the CPU); its Pallas page write fills the
unwritten tail slots of a partial page and is not the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu_torch.kernels import kv_cache as tkvc
from torch_port_util import to_np, to_torch

L, P, PS, D = 2, 6, 16, 32


def _both_caches(H, seed, kv_bits=4):
    """The same non-zero starting cache on both sides, so untouched bytes
    are checked too."""
    t = tkvc.create_kv_cache(L, P, H, PS, D, kv_bits, device="cpu")
    r = np.random.default_rng(seed)
    t.data.copy_(torch.from_numpy(r.integers(-128, 128, t.data.shape).astype(np.int8)))
    t.scales.copy_(torch.from_numpy(r.random(t.scales.shape).astype(np.float32)))
    jdtype = jnp.bfloat16 if t.scales.dtype == torch.bfloat16 else jnp.float32
    j = jkvc.KVCache(
        data=jnp.asarray(t.data.numpy()),
        scales=jnp.asarray(to_np(t.scales)).astype(jdtype),
    )
    return t, j


def _assert_same(t, j):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    js = to_torch(j.scales)
    assert t.scales.dtype == js.dtype
    bits = torch.int16 if js.element_size() == 2 else torch.int32
    np.testing.assert_array_equal(t.scales.view(bits).numpy(), js.view(bits).numpy())


def _kv(T, H, seed):
    r = np.random.default_rng(seed)
    k = torch.from_numpy(r.standard_normal((L, T, H, D)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(r.standard_normal((L, T, H, D)).astype(np.float32)).to(torch.bfloat16)
    return k, v


@pytest.mark.parametrize("H,scale_dtype", [(8, torch.bfloat16), (2, torch.float32)])
def test_scale_dtype_rule(H, scale_dtype):
    t = tkvc.create_kv_cache(L, P, H, PS, D, 4, device="cpu")
    j = jkvc.create_kv_cache(L, P, H, PS, D, 4)
    assert t.scales.dtype == scale_dtype == to_torch(j.scales).dtype
    assert tuple(t.data.shape) == j.data.shape and tuple(t.scales.shape) == j.scales.shape


@pytest.mark.parametrize("H", [8, 2])
def test_prefill_then_decode_appends_byte_identical(H):
    t, j = _both_caches(H, seed=H)
    # prefill: two prompts (20 and 7 tokens) packed, 5 padding tokens
    pages = np.array([0] * 16 + [1] * 4 + [4] * 7 + [-1] * 5, np.int32)
    slots = np.array(list(range(16)) + list(range(4)) + list(range(7)) + [0] * 5,
                     np.int32)
    k, v = _kv(len(pages), H, seed=1)
    tkvc.append_all_layers(t, k, v, torch.from_numpy(pages),
                           torch.from_numpy(slots), 4, True)
    j = jkvc.append_all_layers(j, jnp.asarray(to_np(k)).astype(jnp.bfloat16),
                               jnp.asarray(to_np(v)).astype(jnp.bfloat16),
                               jnp.asarray(pages), jnp.asarray(slots), 4, True,
                               max_stages=0)
    _assert_same(t, j)
    # two decode steps: one token per sequence into its last page, one pad row
    for step in range(2):
        pages = np.array([1, 4, -1], np.int32)
        slots = np.array([4 + step, 7 + step, 0], np.int32)
        k, v = _kv(3, H, seed=10 + step)
        tkvc.append_all_layers(t, k, v, torch.from_numpy(pages),
                               torch.from_numpy(slots), 4, True)
        j = jkvc.append_all_layers(j, jnp.asarray(to_np(k)).astype(jnp.bfloat16),
                                   jnp.asarray(to_np(v)).astype(jnp.bfloat16),
                                   jnp.asarray(pages), jnp.asarray(slots), 4, True)
        _assert_same(t, j)


@pytest.mark.parametrize("zero_point", [True, False])
def test_quantize_rows_identical(zero_point):
    k, v = _kv(5, 2, seed=3)
    rt, st = tkvc._quantize_rows(k, v, 4, zero_point)
    rj, sj = jkvc._quantize_rows(jnp.asarray(to_np(k)), jnp.asarray(to_np(v)), 4,
                                 zero_point)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("H", [8, 2])
def test_gather_dequant_layer_identical(H):
    t, j = _both_caches(H, seed=5)
    bt = np.array([[3, 0, 5], [1, 1, 2]], np.int32)
    kt, vt = tkvc.gather_dequant_layer(t.layer(1), torch.from_numpy(bt), 4)
    kj, vj = jkvc.gather_dequant_layer(j.layer(1), jnp.asarray(bt), 4)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("H", [8, 2])
def test_kv8_append_and_gather_identical(H, zero_point):
    """KV8: a row is H * D bytes of u - 128. Prefill and decode appends leave
    the same bytes on both sides, and the pages dequantize to equal values."""
    t, j = _both_caches(H, seed=H, kv_bits=8)
    assert t.data.shape[-1] == H * D and t.head_dim(8) == D
    steps = [
        (np.array([0] * 16 + [1] * 4 + [4] * 7 + [-1] * 5, np.int32),
         np.array(list(range(16)) + list(range(4)) + list(range(7)) + [0] * 5, np.int32)),
        (np.array([1, 4, -1], np.int32), np.array([4, 7, 0], np.int32)),
    ]
    for i, (pages, slots) in enumerate(steps):
        k, v = _kv(len(pages), H, seed=20 + i)
        tkvc.append_all_layers(t, k, v, torch.from_numpy(pages),
                               torch.from_numpy(slots), 8, zero_point)
        j = jkvc.append_all_layers(j, jnp.asarray(to_np(k)).astype(jnp.bfloat16),
                                   jnp.asarray(to_np(v)).astype(jnp.bfloat16),
                                   jnp.asarray(pages), jnp.asarray(slots), 8,
                                   zero_point, max_stages=0)
        _assert_same(t, j)
    bt = np.array([[0, 1, 5], [4, 4, 2]], np.int32)
    kt, vt = tkvc.gather_dequant_layer(t.layer(1), torch.from_numpy(bt), 8)
    kj, vj = jkvc.gather_dequant_layer(j.layer(1), jnp.asarray(bt), 8)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_create_kv_cache_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        assert tkvc.create_kv_cache(1, 2, 2, PS, D).data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tkvc.create_kv_cache(1, 2, 2, PS, D)
