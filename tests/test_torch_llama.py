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


def _chunk_inputs(ids, start, T, table):
    """One prompt's tokens [start, start + len(ids)) packed into T rows."""
    n = len(ids)
    p = start + np.arange(n)
    z = np.zeros(T - n, np.int32)
    cat = lambda a, pad: np.concatenate([np.asarray(a, np.int32), pad])
    return (cat(ids, z), cat(p, z), cat(np.ones(n), z),
            cat(np.asarray(table)[p // PS], z - 1), cat(p % PS, z),
            np.array([n - 1], np.int32))


def _rows_equal_share(tkv, jkv, pages):
    """Share of the bytes of `pages` (data and scales) equal on both sides;
    a data byte that differs is one step of one nibble off, no more."""
    td = tkv.data[:, pages].numpy().view(np.uint8).astype(np.int32)
    jd = np.asarray(jkv.data)[:, pages].view(np.uint8).astype(np.int32)
    assert np.abs((td & 0xF) - (jd & 0xF)).max() <= 1
    assert np.abs((td >> 4) - (jd >> 4)).max() <= 1
    ts, js = to_np(tkv.scales[:, pages]), np.asarray(jkv.scales, np.float32)[:, pages]
    return (td == jd).mean(), (ts == js).mean()


@pytest.fixture
def appended(monkeypatch):
    """Records the bf16 (k_all, v_all) each side hands to its cache append:
    {"t": [...], "j": [...]}, one entry per append call."""
    rec = {"t": [], "j": []}
    t_append, j_append = tkvc.append_all_layers, jkvc.append_all_layers

    def t_rec(kv, k, v, *a, **kw):
        rec["t"].append((k.clone(), v.clone()))
        return t_append(kv, k, v, *a, **kw)

    def j_rec(kv, k, v, *a, **kw):
        rec["j"].append((k, v))
        return j_append(kv, k, v, *a, **kw)

    monkeypatch.setattr(tkvc, "append_all_layers", t_rec)
    monkeypatch.setattr(jkvc, "append_all_layers", j_rec)
    rec["j_append"] = j_append
    return rec


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x.astype(jnp.bfloat16)).view(np.int16)


def _assert_bytes_follow_kv(tkv, jkv, jkv_before, rec, call, page_ids, slots):
    """Why the two caches may differ after a model step, shown on append
    number `call` of that step:

    1. the append itself is exact: the port's K/V of this step through the
       JAX package's append (onto the JAX cache as it was before the step)
       give the port's bytes, data and scales, on every page written;
    2. so a written row (layer, token) differs between the two caches only
       where the bf16 K/V the two models computed for it differ.

    Returns the number of (layer, token) rows whose K/V differ."""
    tk, tv = rec["t"][call]
    jk, jv = rec["j"][call]
    live = np.flatnonzero(page_ids >= 0)
    pages = sorted(set(page_ids[live].tolist()))
    as_j = lambda x: jnp.asarray(to_np(x)).astype(jnp.bfloat16)
    same_kv = rec["j_append"](jkv_before, as_j(tk), as_j(tv), jnp.asarray(page_ids),
                              jnp.asarray(slots), 4, True)
    np.testing.assert_array_equal(tkv.data[:, pages].numpy(),
                                  np.asarray(same_kv.data)[:, pages])
    np.testing.assert_array_equal(
        to_np(tkv.scales[:, pages]), np.asarray(same_kv.scales, np.float32)[:, pages])

    kv_differ = ((_bf16_bits(tk) != _bf16_bits(jk)).any(axis=(2, 3))
                 | (_bf16_bits(tv) != _bf16_bits(jv)).any(axis=(2, 3)))  # [L, T]
    td, jd = tkv.data.numpy(), np.asarray(jkv.data)
    ts, js = to_np(tkv.scales), np.asarray(jkv.scales, np.float32)
    for t in live:
        p, s = page_ids[t], slots[t]
        row_differs = ((td[:, p, :, s] != jd[:, p, :, s]).any(axis=(1, 2))
                       | (ts[:, p, :, :, s] != js[:, p, :, :, s]).any(axis=(1, 2)))
        assert not (row_differs & ~kv_differ[:, t]).any(), \
            f"token {t}: cache bytes differ though both sides appended the same K/V"
    return int(kv_differ[:, live].sum())


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both sides after a packed prefill of a short prompt (pages 0-1, it
    then decodes) and of the first 32 tokens of a 53-token prompt (pages
    4-5 of its table [4, 5, 6, 7])."""
    jargs, jparams, targs, tparams = pair
    args = (targs.num_layers, 10, targs.num_kv_heads, PS, targs.head_dim)
    tkv = tkvc.create_kv_cache(*args, device="cpu")
    jkv = jkvc.create_kv_cache(*args)
    r = np.random.default_rng(3)
    short = r.integers(1, TINY["vocab_size"], 21).astype(np.int32)
    long = r.integers(1, TINY["vocab_size"], 53).astype(np.int32)
    for ids, table in ((short, [0, 1]), (long[:32], [4, 5, 6, 7])):
        inp = _chunk_inputs(ids, 0, 32, table)
        _, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inp), targs)
        _, jkv = jllama.prefill(jparams, jkv, *map(jnp.asarray, inp), jargs)
    return tkv, jkv, long


def test_prefill_chunk_logits_and_cache(pair, prefilled, appended):
    """Tokens 32..52 as one chunk over the 32 cached ones. Logits within
    ATOL. The chunk's appended cache rows: the append is byte-exact on the
    same K/V, and rows differ only where the two models' bf16 K/V differ
    (_assert_bytes_follow_kv); on this pinned input no K/V row differs, so
    the bytes are equal."""
    jargs, jparams, targs, tparams = pair
    tkv, jkv, long = prefilled
    tkv = tkvc.KVCache(tkv.data.clone(), tkv.scales.clone())
    inp = _chunk_inputs(long[32:], 32, 32, [4, 5, 6, 7])
    bt = np.array([[4, 5, 6, 7]], np.int32)
    tl, tkv = tllama.prefill_chunk(
        tparams, tkv, *map(torch.from_numpy, inp), torch.from_numpy(bt), 32, targs)
    jl, jkv2 = jllama.prefill_chunk(
        jparams, jkv, *map(jnp.asarray, inp), jnp.asarray(bt), jnp.int32(32), jargs)
    assert tl.dtype == torch.float32 and tl.shape == (1, TINY["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    n_differ = _assert_bytes_follow_kv(tkv, jkv2, jkv, appended, 0, inp[3], inp[4])
    data_eq, scale_eq = _rows_equal_share(tkv, jkv2, [6, 7])
    print(f"chunk: {n_differ} K/V rows differ; data bytes {data_eq:.4f}, "
          f"scales {scale_eq:.4f} equal")
    assert n_differ == 0 and data_eq == 1.0 and scale_eq == 1.0


def test_prefill_chunk_with_decode_logits_and_cache(pair, prefilled, appended):
    """The same chunk riding with a decode batch (the short prompt's next
    token, one pad row): logits [1 + B, V] within ATOL, both appends land,
    each byte-exact on the same K/V; on this pinned input the bytes of the
    chunk's rows and of the decode row are equal."""
    jargs, jparams, targs, tparams = pair
    tkv0, jkv, long = prefilled
    tkv = tkvc.KVCache(tkv0.data.clone(), tkv0.scales.clone())
    inp = _chunk_inputs(long[32:], 32, 32, [4, 5, 6, 7])
    bt = np.array([[4, 5, 6, 7]], np.int32)
    d_tok = np.array([17, 0], np.int32)
    d_bt = np.array([[0, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    d_ctx = np.array([22, 0], np.int32)
    tl, tkv = tllama.prefill_chunk_with_decode(
        tparams, tkv, *map(torch.from_numpy, inp), torch.from_numpy(bt), 32,
        *map(torch.from_numpy, (d_tok, d_bt, d_ctx)), targs)
    jl, jkv2 = jllama.prefill_chunk_with_decode(
        jparams, jkv, *map(jnp.asarray, inp), jnp.asarray(bt), jnp.int32(32),
        *map(jnp.asarray, (d_tok, d_bt, d_ctx)), jargs)
    assert tl.shape == (3, TINY["vocab_size"])
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL)
    # pages 6-7: the chunk's rows; page 1: the decode row's slot 21 % 16
    n_differ = _assert_bytes_follow_kv(tkv, jkv2, jkv, appended, 0, inp[3], inp[4])
    d_pages, d_slots = np.array([1, -1], np.int32), np.array([21 % PS, 0], np.int32)
    n_differ += _assert_bytes_follow_kv(tkv, jkv2, jkv, appended, 1, d_pages, d_slots)
    data_eq, scale_eq = _rows_equal_share(tkv, jkv2, [6, 7, 1])
    print(f"mixed: {n_differ} K/V rows differ; data bytes {data_eq:.4f}, "
          f"scales {scale_eq:.4f} equal")
    assert n_differ == 0 and data_eq == 1.0 and scale_eq == 1.0
    # the pad row wrote nothing: page 0 is as the prefill left it
    assert torch.equal(tkv.data[:, 0], tkv0.data[:, 0])
    assert not torch.equal(tkv.data[:, 1], tkv0.data[:, 1])


def test_prefill_cache_bytes_follow_kv(pair, appended):
    """Where the two caches do differ after a model step, the cause is the
    K/V and not the append. A 32-token packed prefill: layer 0's K/V are
    equal on both sides and so are its cache rows; layer 1's input passed
    through layer 0's attention, whose f32 sums land an ulp apart and move
    some bf16 outputs to their neighbour, so some of its K/V rows differ
    and only those rows' bytes do (each data nibble by one step at most)."""
    jargs, jparams, targs, tparams = pair
    args = (targs.num_layers, 10, targs.num_kv_heads, PS, targs.head_dim)
    tkv = tkvc.create_kv_cache(*args, device="cpu")
    jkv0 = jkvc.create_kv_cache(*args)
    long = np.random.default_rng(3).integers(1, TINY["vocab_size"], 32).astype(np.int32)
    inp = _chunk_inputs(long, 0, 32, [4, 5, 6, 7])
    tl, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inp), targs)
    jl, jkv = jllama.prefill(jparams, jkv0, *map(jnp.asarray, inp), jargs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    n_differ = _assert_bytes_follow_kv(tkv, jkv, jkv0, appended, 0, inp[3], inp[4])
    data_eq, scale_eq = _rows_equal_share(tkv, jkv, [4, 5])
    print(f"prefill: {n_differ} of {2 * 32} K/V rows differ; data bytes "
          f"{data_eq:.4f}, scales {scale_eq:.4f} equal")
    tk, jk = appended["t"][0][0], appended["j"][0][0]
    assert (_bf16_bits(tk)[0] == _bf16_bits(jk)[0]).all(), "layer 0 K differs"
    assert n_differ <= 6 and data_eq >= 0.99, (n_differ, data_eq, scale_eq)
