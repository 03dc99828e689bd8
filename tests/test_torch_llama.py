"""Port parity: the dense Llama at W4A8KV4 per-channel. The same tiny
quantized params (made by the JAX package, moved across by
params_from_numpy) and the same packed inputs go through both packages'
prefill and decode.

Tolerance: logits within atol 1e-2 (|logits| ~ 0.3 here). The two sides
round the same values to bf16 and int8 at the same places, but their f32
reductions (RMSNorm's mean square, softmax) and transcendentals (RoPE's
cos/sin) may land an ulp apart. That can move an element of a bf16 tensor
to its neighbour (a relative step of 2^-8): through the final RMSNorm such
a flip moves this model's logits by ~3e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu.models import llama as jllama
from qserve_tpu_torch.kernels import kv_cache as tkvc
from qserve_tpu_torch.models import llama as tllama
from torch_port_util import TINY, tiny_pair, to_np

PS = 16
ATOL = 1e-2


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def _prefill_inputs():
    """Two prompts (21 and 10 tokens) packed into T=32 with one pad token."""
    r = np.random.default_rng(0)
    lens = [21, 10]
    T = 32
    tok = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    seg = np.zeros(T, np.int32)
    pages = np.full(T, -1, np.int32)
    slots = np.zeros(T, np.int32)
    tables = [[0, 1], [2]]
    t = 0
    last = []
    for i, n in enumerate(lens):
        tok[t : t + n] = r.integers(1, TINY["vocab_size"], n)
        pos[t : t + n] = np.arange(n)
        seg[t : t + n] = i + 1
        pages[t : t + n] = [tables[i][p // PS] for p in range(n)]
        slots[t : t + n] = np.arange(n) % PS
        t += n
        last.append(t - 1)
    return (tok, pos, seg, pages, slots, np.array(last, np.int32)), tables, lens


def test_params_from_numpy_layout(pair):
    jargs, jparams, targs, tparams = pair
    L, E = TINY["num_layers"], TINY["hidden_size"]
    assert tparams.layers.qkv.qweight.shape == (L, E // 2, targs.qkv_out)
    assert tparams.layers.qkv.qweight.dtype == torch.int8
    assert tparams.embed.dtype == tparams.lm_head.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams.layers.down.qweight.numpy(), np.asarray(jparams.layers.down.qweight)
    )


def test_prefill_then_decode_logits(pair):
    jargs, jparams, targs, tparams = pair
    args = (targs.num_layers, 8, targs.num_kv_heads, PS, targs.head_dim)
    tkv = tkvc.create_kv_cache(*args, device="cpu")
    jkv = jkvc.create_kv_cache(*args)
    inputs, tables, lens = _prefill_inputs()

    tl, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inputs), targs)
    jl, jkv = jllama.prefill(jparams, jkv, *map(jnp.asarray, inputs), jargs)
    assert tl.dtype == torch.float32 and tl.shape == (2, TINY["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    # eight decode steps over the cache each side wrote, plus one pad row,
    # fed the JAX side's greedy tokens (teacher forcing): the argmax agrees
    # wherever the JAX logits' top two are further apart than the noise
    bt = np.zeros((3, 2), np.int32)
    bt[0, :2] = tables[0]
    bt[1, :1] = tables[1]
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for step in range(8):
        tok = np.array([tok[0], tok[1], 0], np.int32)
        ctx = np.array([lens[0] + 1 + step, lens[1] + 1 + step, 0], np.int32)
        tl, tkv = tllama.decode(tparams, tkv, *map(torch.from_numpy, (tok, bt, ctx)),
                                targs)
        jl, jkv = jllama.decode(jparams, jkv, *map(jnp.asarray, (tok, bt, ctx)),
                                jargs)
        assert np.isfinite(tl.numpy()).all()
        want = np.asarray(jl)[:2]
        np.testing.assert_allclose(tl.numpy()[:2], want, atol=ATOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * ATOL
        np.testing.assert_array_equal(tl.numpy()[:2].argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        tok = want.argmax(-1).astype(np.int32)


def test_random_quantized_params_dense_only():
    args = tllama.LlamaArgs(**TINY, num_experts=4)
    with pytest.raises(AssertionError, match="DENSE"):
        tllama.random_quantized_params(0, args, device="cpu")


def test_quantize_params_matches_jax(pair):
    """The port's own quantizer on the JAX package's float weights gives the
    JAX package's packed params, bit for bit."""
    jargs, _, targs, _ = pair
    fp = jllama.random_float_params(jax.random.PRNGKey(1), jargs)
    jp = jllama.quantize_params(fp, jargs)
    fp_np = jax.tree.map(np.asarray, fp)
    tp = tllama.quantize_params(fp_np, targs, device="cpu")
    for name in ("qkv", "o", "gate_up", "down"):
        for a, b in zip(getattr(tp.layers, name), getattr(jp.layers, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(to_np(tp.lm_head), np.asarray(jp.lm_head, np.float32))
