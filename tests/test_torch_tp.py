"""Port parity of tensor parallelism without processes: per-shard
quantization, the random-weight constructors, the TP-local cache and the collectives'
tp = 1 path, against the JAX package on the virtual CPU devices that
tests/conftest.py provides.

  * quantize_params_tp(rank r) equals the JAX package's global
    quantize_params_tp arrays sliced by their PartitionSpecs
    (tp_shard_from_jax), bit for bit: W4A8 per-channel and g128, W8A8,
    W16A16, the W8 lm_head, a small Mixtral's experts, tp = 2 and 4;
  * random_quantized_params_tp at tp = 1 is random_quantized_params, and
    random_float_params draws the weights random_quantized_params(_tp)
    quantizes;
  * each rank's cache is shard r of the JAX package's sharded cache
    (shape, dtype), and after the same tp = 2 prefill its bytes equal the
    JAX package's append of the mesh's own K/V wherever the two sides'
    bf16 K/V agree (the mesh's cache itself, one fused XLA program, rounds
    some codes one step apart from its own append run op by op). The port's
    two ranks run here as two threads whose collectives exchange tensors
    through a barrier (a bf16 sum of two is the f32 sum rounded once, what
    gloo gives: tests/test_torch_tp_engine.py checks that).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.config import QuantSpec as JQuantSpec
from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu.models import llama as jllama
from qserve_tpu.models import mixtral as jmixtral
from qserve_tpu.parallel import tp as jtp
from qserve_tpu_torch.config import QuantSpec as TQuantSpec
from qserve_tpu_torch.convert.from_jax import tp_shard_from_jax
from qserve_tpu_torch.kernels import kv_cache as tkvc
from qserve_tpu_torch.models import llama as tllama
from qserve_tpu_torch.models import mixtral as tmixtral
from qserve_tpu_torch.parallel import tp as ttp
from qserve_tpu_torch.worker.cache_engine import CacheEngine
from qserve_tpu_torch.config import CacheConfig
from torch_port_util import to_np

# heads 8 / kv heads 8 keep every shard's K and N whole at tp = 4 and the
# 128-wide group whole at tp = 2; 16 kv heads' scales are bf16 globally
GEO = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=8, num_kv_heads=8, head_dim=32)
MOE = dict(GEO, intermediate_size=256, num_experts=4, moe_top_k=2)
# the random builders' tests: no 128-wide group, so half the widths
SMALL = dict(GEO, hidden_size=128, intermediate_size=256)
SMALL_MOE = dict(SMALL, intermediate_size=128, num_experts=4, moe_top_k=2)


def _pair_args(precision, group_size=-1, lm_head_bits=16, tp=2, **geo):
    spec = dict(group_size=group_size, lm_head_bits=lm_head_bits)
    jargs = jllama.LlamaArgs(quant=JQuantSpec.from_precision(precision, **spec),
                             tp_size=tp, **geo)
    targs = tllama.LlamaArgs(quant=TQuantSpec.from_precision(precision, **spec),
                             tp_size=tp, **geo)
    return jargs, targs


def _torch_fp(fp):
    """The JAX package's float weights as CPU f32 tensors."""
    if isinstance(fp, dict):
        return {k: _torch_fp(v) for k, v in fp.items()}
    if isinstance(fp, list):
        return [_torch_fp(v) for v in fp]
    return torch.from_numpy(np.array(fp, np.float32))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [y for item in x for y in _leaves(item)]


def _assert_same_params(got, want):
    assert type(got.layers) is type(want.layers)
    assert type(got.lm_head) is type(want.lm_head)
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.shape, b.shape)
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision,group_size,lm_head_bits,moe,tp", [
    ("w4a8kv4", -1, 16, False, 2),
    ("w4a8kv4", -1, 16, False, 4),
    ("w4a8kv4", 128, 16, False, 2),
    ("w4a8kv8", 128, 8, False, 2),
    ("w8a8kv8", -1, 8, False, 2),
    ("w8a8kv8", -1, 16, False, 4),
    ("w16a16kv8", -1, 16, False, 2),
    ("w16a16kv8", -1, 16, False, 4),
    ("w4a8kv4", -1, 16, True, 2),
    ("w4a8kv4", 128, 16, True, 2),
    ("w8a8kv8", -1, 8, True, 4),
    ("w16a16kv8", -1, 16, True, 2),
])
def test_quantize_params_tp_matches_jax_shards(precision, group_size, lm_head_bits, moe, tp):
    """Every rank's params, bit for bit, are the JAX package's global arrays
    cut by their PartitionSpecs."""
    _hold_shards(precision, group_size, lm_head_bits, tp, MOE if moe else GEO)


def test_quantize_params_tp_g128_at_tp4_matches_jax_shards():
    """g128 at tp = 4: head_dim 64 keeps o's local K (2 heads x 64) and
    down's (512 / 4) whole 128-wide groups."""
    _hold_shards("w4a8kv4", 128, 8, 4, dict(GEO, head_dim=64))


def _hold_shards(precision, group_size, lm_head_bits, tp, geo):
    jargs, targs = _pair_args(precision, group_size, lm_head_bits, tp, **geo)
    build = jmixtral if geo.get("num_experts") else jllama
    fp = build.random_float_params(jax.random.PRNGKey(3), jargs, scale=0.05)
    gparams, specs = jtp.quantize_params_tp(fp, jargs)
    gparams = jax.tree.map(np.asarray, gparams)
    tfp = _torch_fp(jax.tree.map(np.asarray, fp))
    for r in range(tp):
        got = ttp.quantize_params_tp(tfp, targs, r, device="cpu")
        _assert_same_params(got, tp_shard_from_jax(gparams, specs, r, tp, device="cpu"))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_random_quantized_params_tp_at_tp1_is_random_quantized_params(moe):
    _, targs = _pair_args("w4a8kv4", tp=1, **(SMALL_MOE if moe else SMALL))
    build = tmixtral if moe else tllama
    _assert_same_params(ttp.random_quantized_params_tp(5, targs, 0, "cpu"),
                        build.random_quantized_params(5, targs, "cpu"))


def test_tp_runner_from_random_tp_at_tp1_is_from_random():
    """TPModelRunner.from_random_tp at tp = 1 (no process group) holds
    ModelRunner.from_random's params, and never feeds decode on the
    device."""
    from qserve_tpu_torch.worker.model_runner import ModelRunner
    from qserve_tpu_torch.worker.tp_runner import TPModelRunner

    _, targs = _pair_args("w4a8kv4", tp=1, **SMALL)
    got = TPModelRunner.from_random_tp(targs, 64, 16, tp_size=1, seed=5, device="cpu")
    want = ModelRunner.from_random(targs, 64, 16, seed=5, device="cpu")
    _assert_same_params(got.params, want.params)
    assert got.tp_rank == 0 and not got.benchmarking


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_random_float_params_are_what_random_quantized_params_tp_quantizes(moe, tp):
    """The same float weights, drawn in the same order: each rank's
    quantize_params_tp of random_float_params(seed) is
    random_quantized_params_tp(seed) of that rank."""
    _, targs = _pair_args("w4a8kv4", -1, 8, tp, **(SMALL_MOE if moe else SMALL))
    fp = (tmixtral if moe else tllama).random_float_params(9, dataclasses.replace(targs, tp_size=1))
    for r in range(tp):
        _assert_same_params(ttp.quantize_params_tp(fp, targs, r, "cpu"),
                            ttp.random_quantized_params_tp(9, targs, r, "cpu"))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_random_float_params_layout_matches_jax(moe):
    jargs, targs = _pair_args("w4a8kv4", tp=1, **(MOE if moe else GEO))
    want = jax.tree.map(np.asarray, (jmixtral if moe else jllama).random_float_params(
        jax.random.PRNGKey(0), jargs))
    got = (tmixtral if moe else tllama).random_float_params(0, targs)

    def layout(x):
        if isinstance(x, dict):
            return {k: layout(v) for k, v in x.items()}
        if isinstance(x, list):
            return [layout(v) for v in x]
        return (tuple(x.shape), str(x.dtype).replace("torch.", ""))

    assert layout(got) == layout(want)  # keys, shapes and dtypes
    # the JAX package's scale: N(0, 0.02) weights, unit norms
    assert abs(float(got["layers"][0]["qkv"].std()) - 0.02) < 2e-3
    assert torch.equal(got["final_ln"], torch.ones(targs.hidden_size))


def test_collectives_are_noops_at_tp1():
    """At tp = 1 the helpers return their input itself, with no group."""
    assert ttp.get_tp_group() is None
    args = tllama.LlamaArgs(**GEO)
    x = torch.randn(3, 8).to(torch.bfloat16)
    calls = dict(ttp.STATS.calls)
    assert ttp.tp_all_reduce(x, args) is x
    assert ttp.tp_all_gather_cols(x, args) is x
    assert ttp.STATS.calls == calls
    with pytest.raises(RuntimeError, match="init_distributed"):
        ttp.tp_all_reduce(x, dataclasses.replace(args, tp_size=2))


def test_shard_weight_takes_head_and_channel_blocks():
    """qkv's shard r is q_r ++ k_r ++ v_r and gate_up's g_r ++ u_r: columns
    numbered by their global index come out in that order."""
    args = tllama.LlamaArgs(**dict(GEO, tp_size=2))
    qkv = torch.arange(args.qkv_out, dtype=torch.float32)[None].repeat(2, 1)
    q, kv = args.q_size_local, args.kv_size_local
    got = ttp.shard_weight(qkv, "qkv", args, 1)[0].long().tolist()
    assert got == (list(range(q, 2 * q)) + list(range(args.q_size + kv, args.q_size + 2 * kv))
                   + list(range(args.q_size + args.kv_size + kv, args.qkv_out)))
    I, il = args.intermediate_size, args.intermediate_local
    gu = torch.arange(2 * I, dtype=torch.float32)[None]
    assert ttp.shard_weight(gu, "gate_up", args, 0)[0].long().tolist() == (
        list(range(il)) + list(range(I, I + il)))
    down = torch.arange(I, dtype=torch.float32)[:, None]
    assert ttp.shard_weight(down, "down", args, 1)[:, 0].long().tolist() == list(range(il, I))


# ---------------------------------------------------------------------------
# the TP-local cache against the JAX package's sharded cache
# ---------------------------------------------------------------------------

PS, PAGES = 16, 8


class _ThreadRanks:
    """n threads standing in for n ranks: each collective deposits the
    rank's tensor, waits for all, and reads every rank's in rank order."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)
        self.local = threading.local()

    def _exchange(self, x):
        self.slots[self.local.rank] = x
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts

    def all_reduce(self, x, args):
        parts = self._exchange(x)
        acc = parts[0].to(torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(torch.float32)
        return acc.to(x.dtype)

    def all_gather_cols(self, x, args):
        return torch.cat(self._exchange(x), dim=-1)

    def run(self, fn):
        out, errors = [None] * self.n, []

        def body(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if errors:
            raise errors[0]
        return out


def _prefill_inputs(V):
    """Two prompts (21 and 10 tokens) packed into 32 rows with a pad row."""
    r = np.random.default_rng(0)
    T, lens, tables = 32, [21, 10], [[0, 1], [2]]
    tok, pos, seg = (np.zeros(T, np.int32) for _ in range(3))
    pages, slots = np.full(T, -1, np.int32), np.zeros(T, np.int32)
    t, last = 0, []
    for i, n in enumerate(lens):
        tok[t:t + n] = r.integers(1, V, n)
        pos[t:t + n] = np.arange(n)
        seg[t:t + n] = i + 1
        pages[t:t + n] = [tables[i][p // PS] for p in range(n)]
        slots[t:t + n] = np.arange(n) % PS
        t += n
        last.append(t - 1)
    return tok, pos, seg, pages, slots, np.array(last, np.int32)


def _bits(x):
    """bf16 bit patterns of a bf16 (or bf16-valued) array."""
    return np.asarray(x).astype(jnp.bfloat16).view(np.uint16)


@pytest.mark.parametrize("precision", ["w4a8kv4", "w8a8kv8"])
def test_tp2_cache_is_the_jax_shard_and_its_bytes_follow_kv(precision, monkeypatch):
    jargs, targs = _pair_args(precision, tp=2, **GEO)
    fp = jllama.random_float_params(jax.random.PRNGKey(1), jargs, scale=0.05)
    inputs = _prefill_inputs(GEO["vocab_size"])

    # the JAX mesh: the prefill step of build_step_fns, the K/V each tp
    # shard appends caught by a debug callback
    jkv_rec = {}
    real_append = jkvc.append_all_layers

    def spy(kv, k_all, v_all, *a, **k):
        jax.debug.callback(
            lambda i, kk, vv: jkv_rec.__setitem__(int(i), (np.asarray(kk), np.asarray(vv))),
            jax.lax.axis_index("tp"), k_all, v_all)
        return real_append(kv, k_all, v_all, *a, **k)

    monkeypatch.setattr(jkvc, "append_all_layers", spy)
    mesh = jtp.make_mesh(1, 2)
    gparams, specs = jtp.quantize_params_tp(fp, jargs)
    cache = jtp.shard_kv_cache(jkvc.create_kv_cache(
        GEO["num_layers"], PAGES, GEO["num_kv_heads"], PS, GEO["head_dim"],
        jargs.quant.kv_bits), mesh)
    prefill_fn, *_ = jtp.build_step_fns(jargs, mesh, specs)
    samp = (np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.int32))
    _, jcache = prefill_fn(jtp.shard_params(gparams, specs, mesh), cache,
                           *map(jnp.asarray, inputs + samp), jax.random.PRNGKey(0))
    jax.block_until_ready(jcache)

    def shard(arr, axis):
        """{rank: numpy} of a tp-sharded array's shards."""
        out = {}
        for s in arr.addressable_shards:
            sl = s.index[axis]
            out[sl.start // (sl.stop - sl.start)] = np.asarray(s.data)
        return out

    jdata, jscales = shard(jcache.data, 4), shard(jcache.scales, 3)

    # the port: two thread-ranks, each its own params and CacheEngine
    ranks = _ThreadRanks(2)
    monkeypatch.setattr(ttp, "tp_all_reduce", ranks.all_reduce)
    monkeypatch.setattr(ttp, "tp_all_gather_cols", ranks.all_gather_cols)
    tkv_rec = {}
    real_t_append = tkvc.append_all_layers

    def t_spy(kv, k_all, v_all, *a, **k):
        tkv_rec[ranks.local.rank] = (k_all.clone(), v_all.clone())
        return real_t_append(kv, k_all, v_all, *a, **k)

    monkeypatch.setattr(tkvc, "append_all_layers", t_spy)
    tfp = _torch_fp(jax.tree.map(np.asarray, fp))
    cc = CacheConfig(block_size=PS, num_device_pages=PAGES, quant=targs.quant)

    def rank_prefill(r):
        params = ttp.quantize_params_tp(tfp, targs, r, "cpu")
        ce = CacheEngine(GEO["num_layers"], GEO["num_kv_heads"], GEO["head_dim"], cc,
                         device="cpu", tp_size=2)
        logits, kv = tllama.prefill(params, ce.cache, *map(torch.from_numpy, inputs), targs)
        return logits, kv

    outs = ranks.run(rank_prefill)
    assert torch.equal(outs[0][0], outs[1][0]), "the ranks' logits differ"
    pages, slots = inputs[3], inputs[4]
    live = np.flatnonzero(pages >= 0)
    written = sorted(set(pages[live].tolist()))

    def j_append(shard_scales, k, v):
        """The JAX package's append (outside any jit) of K/V [L, T, Hloc, D]
        onto an empty cache of one shard's layout."""
        kv = jkvc.create_kv_cache(GEO["num_layers"], PAGES, k.shape[2], PS, GEO["head_dim"],
                                  jargs.quant.kv_bits, scale_dtype=shard_scales.dtype)
        kv = real_append(kv, jnp.asarray(k).astype(jnp.bfloat16),
                         jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(pages),
                         jnp.asarray(slots), jargs.quant.kv_bits, True)
        return np.asarray(kv.data), np.asarray(kv.scales, np.float32)

    n_differ = n_fused = 0
    for r, (_, tkv) in enumerate(outs):
        # the layout: shard r of the JAX cache
        assert tuple(tkv.data.shape) == jdata[r].shape
        assert tuple(tkv.scales.shape) == jscales[r].shape
        assert str(tkv.scales.dtype).replace("torch.", "") == str(jscales[r].dtype)
        td, ts = tkv.data.numpy(), to_np(tkv.scales)
        tk, tv = (to_np(x) for x in tkv_rec[r])
        jk, jv = jkv_rec[r]
        # 1. the append is exact: the port's K/V through the JAX package's
        #    append give the port's bytes
        same_d, same_s = j_append(jscales[r], tk, tv)
        np.testing.assert_array_equal(td[:, written], same_d[:, written])
        np.testing.assert_array_equal(ts[:, written], same_s[:, written])
        # 2. so a row differs from the JAX package's append of the mesh's own
        #    K/V only where the two sides' bf16 K/V differ
        jd, js = j_append(jscales[r], jk, jv)
        kv_differ = ((_bits(tk) != _bits(jk)).any(axis=(2, 3))
                     | (_bits(tv) != _bits(jv)).any(axis=(2, 3)))  # [L, T]
        for t in live:
            p, s = pages[t], slots[t]
            row_differs = ((td[:, p, :, s] != jd[:, p, :, s]).any(axis=(1, 2))
                           | (ts[:, p, :, :, s] != js[:, p, :, :, s]).any(axis=(1, 2)))
            assert not (row_differs & ~kv_differ[:, t]).any(), \
                f"rank {r} token {t}: cache bytes differ though the K/V agree"
            # the mesh's step is one XLA program, whose fused quantizer may
            # round a code one step apart from the same quantizer run op by
            # op (the port's reference): counted, not held
            n_fused += int((jdata[r][:, p, :, s] != jd[:, p, :, s]).any(axis=(1, 2)).sum())
        n_differ += int(kv_differ[:, live].sum())
        assert (~kv_differ[:, live]).any(), "no row to compare"
    print(f"{precision}: {n_differ} of 2 x {2 * len(live)} (layer, token) K/V rows "
          f"differ; the mesh's fused quantize moved {n_fused} rows")
