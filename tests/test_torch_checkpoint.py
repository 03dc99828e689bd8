"""Port parity of checkpoints and text: the safetensors reader and writer,
HF self-quantization (dense at four precisions, Mixtral), the packed QoQ
checkpoint across the two packages, engines built from a checkpoint
directory with a tokenizer (greedy tokens, text, EOS, stop strings,
special tokens), the chat templates, e2e_generation, and the
benchmarking device-feed decode. Everything is written in tmp_path from a
numpy seed, the tokenizer too; nothing is downloaded."""

import json
import os
import re
import shutil
import struct
import sys

# tokenizers load from local directories only
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax  # noqa: E402
import numpy as np
import pytest
import torch

from qserve_tpu import conversation as jconv
from qserve_tpu.config import QuantSpec as JQ
from qserve_tpu.convert import checkpoint_converter as jcc
from qserve_tpu.engine.arg_utils import EngineArgs as JEngineArgs
from qserve_tpu.entrypoints import e2e_generation as je2e
from qserve_tpu.models import loader as jloader
from qserve_tpu.models import mixtral as jmixtral
from qserve_tpu.sampling_params import SamplingParams as JSP
from qserve_tpu_torch import conversation as tconv
from qserve_tpu_torch.config import QuantSpec as TQ
from qserve_tpu_torch.convert import checkpoint_converter as tcc
from qserve_tpu_torch.convert.from_jax import params_from_numpy
from qserve_tpu_torch.engine.arg_utils import AsyncEngineArgs, EngineArgs
from qserve_tpu_torch.entrypoints import e2e_generation as te2e
from qserve_tpu_torch.models import loader as tloader
from qserve_tpu_torch.models import mixtral as tmixtral
from qserve_tpu_torch.sampling_params import SamplingParams as TSP
from qserve_tpu_torch.utils import weight_utils as wu

CFG = dict(
    architectures=["LlamaForCausalLM"], vocab_size=256, hidden_size=128,
    intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6,
)
PRECISIONS = [("w4a8kv4", -1), ("w4a8kv4", 128), ("w8a8kv8", -1), ("w16a16kv8", -1)]
# engines: a small cache and few shapes (the JAX side compiles each)
ENGINE = dict(block_size=16, num_device_pages=32, max_model_len=128,
              max_num_batched_tokens=128, max_num_seqs=4, seed=0)

# the tokenizer: every word of e2e_generation's prompts, then filler words,
# one entry per vocab id
_SPECIAL = ["<unk>", "<s>", "</s>"]
_WORDS = sorted(set(re.findall(r"\w+|[^\w\s]+", " ".join(je2e.DEFAULT_PROMPTS))))
VOCAB = _SPECIAL + _WORDS + [f"w{i}" for i in range(CFG["vocab_size"] - 3 - len(_WORDS))]
# a prompt whose greedy stream starts with five distinct ordinary words
# (EOS and the stop string each cut it at one of them)
TEXT = "capital process three . France search three What a the"


def _hf_state(cfg, rng, dtype=np.float32):
    """HF llama weights ([out, in]) at cfg's widths; norms away from 1."""
    E, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = E // H

    def w(*shape):
        return (rng.standard_normal(shape, np.float32) * 0.05).astype(dtype)

    def ln():
        return (1 + 0.1 * rng.standard_normal(E, np.float32)).astype(dtype)

    state = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": ln(),
             "lm_head.weight": w(V, E)}
    for li in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{li}"
        state.update({
            f"{p}.input_layernorm.weight": ln(),
            f"{p}.post_attention_layernorm.weight": ln(),
            f"{p}.self_attn.q_proj.weight": w(H * D, E),
            f"{p}.self_attn.k_proj.weight": w(KV * D, E),
            f"{p}.self_attn.v_proj.weight": w(KV * D, E),
            f"{p}.self_attn.o_proj.weight": w(E, H * D),
            f"{p}.mlp.gate_proj.weight": w(I, E),
            f"{p}.mlp.up_proj.weight": w(I, E),
            f"{p}.mlp.down_proj.weight": w(E, I),
        })
    return state


def _write_hf(d, cfg, state):
    """An HF directory: config.json and one safetensors file (the port's
    writer; the JAX package reads it through the safetensors library)."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    wu.write_safetensors({k: torch.from_numpy(v) for k, v in state.items()},
                         os.path.join(d, "model.safetensors"))
    return str(d)


def _save_tokenizer(d, eos="</s>", special=()):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(VOCAB)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token=eos,
        additional_special_tokens=list(special),
    ).save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny Llama HF directory with its tokenizer."""
    d = _write_hf(tmp_path_factory.mktemp("tiny_hf"), CFG,
                  _hf_state(CFG, np.random.default_rng(0)))
    _save_tokenizer(d)
    return d


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for y in x for leaf in _leaves(y)]


def _assert_bit_equal(got, want):
    """Port params (CPU) against the JAX package's (or the port's own)."""
    if not isinstance(want.embed, torch.Tensor):
        want = params_from_numpy(jax.tree.map(np.asarray, want), device="cpu")
    assert type(got.layers) is type(want.layers)
    for name in type(want.layers)._fields:
        assert type(getattr(got.layers, name)) is type(getattr(want.layers, name)), name
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool else a,
                           b.view(torch.uint8) if b.dtype == torch.bool else b)


# ---------------------------------------------------------------------------
# safetensors I/O
# ---------------------------------------------------------------------------

def _all_dtypes():
    g = torch.Generator().manual_seed(0)
    return {
        "f64": torch.randn(3, 2, generator=g, dtype=torch.float64),
        "f32": torch.randn(5, generator=g),
        "f16": torch.randn(2, 3, generator=g).half(),
        "bf16": torch.randn(4, 3, generator=g).bfloat16(),
        "i64": torch.randint(-2**40, 2**40, (3,), generator=g),
        "i32": torch.randint(-2**30, 2**30, (2, 2), generator=g, dtype=torch.int32),
        "i16": torch.randint(-2**15, 2**15, (7,), generator=g, dtype=torch.int16),
        "i8": torch.randint(-128, 128, (3, 3), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (5,), generator=g, dtype=torch.uint8),
        "bool": torch.rand(6, generator=g) > 0.5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_writer_is_read_by_the_safetensors_library(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import load_file

    ts = _all_dtypes()
    path = str(tmp_path / "x.safetensors")
    size = wu.write_safetensors(ts, path, metadata={"format": "pt"})
    assert size == os.path.getsize(path)
    with open(path, "rb") as f:
        assert struct.unpack("<Q", f.read(8))[0] % 8 == 0  # header padded to 8
    got = load_file(path)
    assert set(got) == set(ts)
    for k, t in ts.items():
        g = got[k]
        assert g.shape == tuple(t.shape)
        if t.dtype == torch.bfloat16:  # raw bits: numpy's bf16 is JAX's ml_dtypes
            np.testing.assert_array_equal(g.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(g, t.numpy())
    with safe_open(path, framework="np") as f:
        assert f.metadata() == {"format": "pt"}


def test_reader_reads_library_files_bit_for_bit(tmp_path):
    from safetensors.torch import save_file

    ts = {k: v for k, v in _all_dtypes().items()}
    path = str(tmp_path / "lib.safetensors")
    save_file(ts, path, metadata={"k": "v"})
    got = wu.read_safetensors(path)
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape
        assert torch.equal(got[k].view(torch.uint8) if t.dtype == torch.bool else got[k],
                           t.view(torch.uint8) if t.dtype == torch.bool else t)


def _corrupt(path, how):
    raw = open(path, "rb").read()
    n = struct.unpack("<Q", raw[:8])[0]
    header = json.loads(raw[8:8 + n])
    if how == "truncated":
        return raw[:-3]
    if how == "short":
        return raw[:5]
    if how == "header_length":
        return struct.pack("<Q", len(raw)) + raw[8:]
    if how == "not_json":
        return raw[:8] + b"}" + raw[9:]
    # overlap: the second tensor starts inside the first
    names = sorted((k for k in header if k != "__metadata__"),
                   key=lambda k: header[k]["data_offsets"][0])
    a, b = header[names[0]], header[names[1]]
    size = b["data_offsets"][1] - b["data_offsets"][0]
    b["data_offsets"] = [a["data_offsets"][1] - 4, a["data_offsets"][1] - 4 + size]
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    return struct.pack("<Q", len(blob)) + blob + raw[8 + n:]


@pytest.mark.parametrize("how", ["truncated", "short", "header_length", "not_json", "overlap"])
def test_reader_refuses_a_corrupt_file(tmp_path, how):
    path = str(tmp_path / "x.safetensors")
    wu.write_safetensors({"a": torch.ones(8), "b": torch.ones(8)}, path)
    bad = str(tmp_path / "bad.safetensors")
    with open(bad, "wb") as f:
        f.write(_corrupt(path, how))
    with pytest.raises(ValueError):
        wu.read_safetensors(bad)


# ---------------------------------------------------------------------------
# HF self-quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,gs", PRECISIONS)
def test_hf_self_quantize_equals_the_jax_package(hf_dir, precision, gs):
    jargs, jparams = jloader.load_model(hf_dir, JQ.from_precision(precision, gs))
    targs, tparams = tloader.load_model(hf_dir, TQ.from_precision(precision, gs), device="cpu")
    assert (targs.num_layers, targs.head_dim, targs.qkv_out) == \
        (jargs.num_layers, jargs.head_dim, jargs.q_size + 2 * jargs.kv_size)
    _assert_bit_equal(tparams, jparams)


def test_tied_embeddings_and_a_bin_file(hf_dir, tmp_path):
    """No lm_head.weight: embed.T serves (both packages). A torch .bin
    directory loads as its safetensors twin does."""
    state = wu.read_safetensors(os.path.join(hf_dir, "model.safetensors"))
    tied = {k: v for k, v in state.items() if k != "lm_head.weight"}
    d = _write_hf(tmp_path / "tied", CFG, {k: v.numpy() for k, v in tied.items()})
    q = "w4a8kv4"
    _, jparams = jloader.load_model(d, JQ.from_precision(q))
    _, tparams = tloader.load_model(d, TQ.from_precision(q), device="cpu")
    _assert_bit_equal(tparams, jparams)
    assert torch.equal(tparams.lm_head, tparams.embed.T)

    b = tmp_path / "bin"
    b.mkdir()
    shutil.copy(os.path.join(hf_dir, "config.json"), b / "config.json")
    torch.save({k: v.clone() for k, v in state.items()}, b / "pytorch_model.bin")
    assert wu.hf_weight_files(str(b)) == ([str(b / "pytorch_model.bin")], "pt")
    _, jbin = jloader.load_model(str(b), JQ.from_precision(q))
    _, tbin = tloader.load_model(str(b), TQ.from_precision(q), device="cpu")
    _, tst = tloader.load_model(hf_dir, TQ.from_precision(q), device="cpu")
    _assert_bit_equal(tbin, jbin)
    _assert_bit_equal(tbin, tst)


def test_unknown_architecture_and_missing_weights_raise(hf_dir, tmp_path):
    d = tmp_path / "gpt"
    shutil.copytree(hf_dir, d)
    with open(d / "config.json", "w") as f:
        json.dump(dict(CFG, architectures=["GPT2LMHeadModel"]), f)
    with pytest.raises(NotImplementedError, match="GPT2LMHeadModel"):
        jloader.load_model(str(d), JQ.from_precision("w4a8kv4"))
    with pytest.raises(NotImplementedError, match="GPT2LMHeadModel"):
        tloader.load_model(str(d), TQ.from_precision("w4a8kv4"), device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    shutil.copy(os.path.join(hf_dir, "config.json"), empty / "config.json")
    with pytest.raises(FileNotFoundError):  # never random weights in its place
        EngineArgs(model=str(empty), device="cpu", **ENGINE).build_engine()


def test_bf16_file_equals_its_f32_upcast(tmp_path):
    """Port only: the JAX package reads bf16 files through JAX's numpy
    dtype registration. bf16 tensors stay bf16 until quantize_params
    widens them, exactly."""
    state = _hf_state(CFG, np.random.default_rng(3))
    bf = {k: torch.from_numpy(v).bfloat16() for k, v in state.items()}
    d16 = tmp_path / "bf16"
    d16.mkdir()
    with open(d16 / "config.json", "w") as f:
        json.dump(CFG, f)
    wu.write_safetensors(bf, str(d16 / "model.safetensors"))
    d32 = _write_hf(tmp_path / "f32", CFG, {k: v.float().numpy() for k, v in bf.items()})
    args = tloader.args_from_config_dict(CFG, TQ.from_precision("w4a8kv4", 128))
    fp = tloader.load_float_params_from_hf(str(d16), args)
    assert fp["embed"].dtype == torch.bfloat16 and fp["layers"][0]["qkv"].dtype == torch.bfloat16
    for q in ("w4a8kv4", "w8a8kv8"):
        _, p16 = tloader.load_model(str(d16), TQ.from_precision(q, 128 if q == "w4a8kv4" else -1),
                                    device="cpu")
        _, p32 = tloader.load_model(d32, TQ.from_precision(q, 128 if q == "w4a8kv4" else -1),
                                    device="cpu")
        _assert_bit_equal(p16, p32)


# ---------------------------------------------------------------------------
# Mixtral from HF
# ---------------------------------------------------------------------------

MIX = dict(CFG, architectures=["MixtralForCausalLM"], num_local_experts=4,
           num_experts_per_tok=2, rope_theta=1e6, rms_norm_eps=1e-5)


def _mixtral_state(rng):
    state = {k: v for k, v in _hf_state(MIX, rng).items() if ".mlp." not in k}
    E, I = MIX["hidden_size"], MIX["intermediate_size"]
    for li in range(MIX["num_hidden_layers"]):
        p = f"model.layers.{li}.block_sparse_moe"
        state[f"{p}.gate.weight"] = rng.standard_normal((4, E), np.float32) * 0.5
        for e in range(4):
            for name, shape in (("w1", (I, E)), ("w3", (I, E)), ("w2", (E, I))):
                state[f"{p}.experts.{e}.{name}.weight"] = \
                    rng.standard_normal(shape, np.float32) * 0.05
    return state


def test_mixtral_hf_float_dict_and_moe_params(tmp_path):
    d = _write_hf(tmp_path / "mixtral", MIX, _mixtral_state(np.random.default_rng(5)))
    q = "w4a8kv4"
    jargs = jmixtral.args_from_config_dict(MIX, JQ.from_precision(q))
    targs = tmixtral.args_from_config_dict(MIX, TQ.from_precision(q))
    jfp = jmixtral.load_float_params_from_hf(d, jargs)
    tfp = tmixtral.load_float_params_from_hf(d, targs)
    np.testing.assert_array_equal(tfp["embed"].numpy(), jfp["embed"])
    np.testing.assert_array_equal(tfp["lm_head"].numpy(), jfp["lm_head"])
    for jl, tl in zip(jfp["layers"], tfp["layers"]):
        for k in ("input_ln", "post_ln", "qkv", "o", "router"):
            np.testing.assert_array_equal(tl[k].numpy(), jl[k])
        for k in ("experts_gate_up", "experts_down"):
            assert len(tl[k]) == 4
            for a, b in zip(tl[k], jl[k]):
                np.testing.assert_array_equal(a.numpy(), b)
    targs2, tparams = tloader.load_model(d, TQ.from_precision(q), quant_path="ignored",
                                         device="cpu")
    assert targs2.num_experts == 4 and targs2.moe_top_k == 2
    _, jparams = jloader.load_model(d, JQ.from_precision(q), quant_path="ignored")
    _assert_bit_equal(tparams, jparams)


# ---------------------------------------------------------------------------
# the packed checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,gs", PRECISIONS)
def test_jax_packed_loads_in_the_port(hf_dir, tmp_path, precision, gs):
    jargs, jparams = jloader.load_model(hf_dir, JQ.from_precision(precision, gs))
    out = str(tmp_path / "packed")
    jcc.save_packed_checkpoint(jparams, jargs, out)
    targs = tcc.load_packed_config(out)
    assert targs == tloader.args_from_config_dict(CFG, TQ.from_precision(precision, gs))
    _assert_bit_equal(tcc.load_packed_checkpoint(out, targs, device="cpu"), jparams)


@pytest.mark.parametrize("precision,gs", PRECISIONS)
def test_port_packed_loads_in_the_jax_package(hf_dir, tmp_path, precision, gs):
    quant = TQ.from_precision(precision, gs)
    targs, tparams = tloader.load_model(hf_dir, quant, device="cpu")
    out = str(tmp_path / "packed")
    tcc.save_packed_checkpoint(tparams, targs, out)
    jargs = jcc.load_packed_config(out)
    assert jargs == jloader.args_from_config_dict(CFG, JQ.from_precision(precision, gs))
    jparams = jcc.load_packed_checkpoint(out, jargs)
    _assert_bit_equal(tparams, jparams)
    # the port reads its own file back, and refuses it for another precision
    _assert_bit_equal(tcc.load_packed_checkpoint(out, targs, device="cpu"), tparams)
    other = "w8a8kv8" if precision != "w8a8kv8" else "w4a8kv4"
    with pytest.raises(ValueError, match="takes"):
        tcc.load_packed_checkpoint(
            out, tloader.args_from_config_dict(CFG, TQ.from_precision(other)), device="cpu")


@pytest.mark.parametrize("layout", [1, None])
def test_packed_layout_v1_refused_by_both(hf_dir, tmp_path, layout):
    jargs, jparams = jloader.load_model(hf_dir, JQ.from_precision("w4a8kv4"))
    out = str(tmp_path / "packed")
    jcc.save_packed_checkpoint(jparams, jargs, out)
    cfg_path = os.path.join(out, "qserve_tpu_config.json")
    meta = json.load(open(cfg_path))
    if layout is None:
        del meta["pack_layout"]
    else:
        meta["pack_layout"] = layout
    json.dump(meta, open(cfg_path, "w"))
    targs = tloader.args_from_config_dict(CFG, TQ.from_precision("w4a8kv4"))
    with pytest.raises(ValueError, match="pack layout v1"):
        jcc.load_packed_checkpoint(out, jargs)
    with pytest.raises(ValueError, match="pack layout v1"):
        tcc.load_packed_checkpoint(out, targs, device="cpu")


def test_packed_refuses_experts_and_a_w8_lm_head(hf_dir, tmp_path):
    targs, tparams = tloader.load_model(hf_dir, TQ.from_precision("w4a8kv4"), device="cpu")
    out = str(tmp_path / "packed")
    tcc.save_packed_checkpoint(tparams, targs, out)
    cfg_path = os.path.join(out, "qserve_tpu_config.json")
    meta = json.load(open(cfg_path))
    json.dump(dict(meta, num_experts=4), open(cfg_path, "w"))
    with pytest.raises(ValueError, match="no router"):
        tcc.load_packed_config(out)
    # W8 lm_head: the JAX package's save fails; the port's says so
    q8 = dict(lm_head_bits=8)
    jargs, jparams = jloader.load_model(hf_dir, JQ.from_precision("w4a8kv4", **q8))
    with pytest.raises(ValueError, match="sequence"):
        jcc.save_packed_checkpoint(jparams, jargs, str(tmp_path / "j8"))
    targs, tparams = tloader.load_model(hf_dir, TQ.from_precision("w4a8kv4", **q8), device="cpu")
    with pytest.raises(NotImplementedError, match="W8 lm_head"):
        tcc.save_packed_checkpoint(tparams, targs, str(tmp_path / "t8"))


def test_convert_hf_checkpoint(hf_dir, tmp_path):
    out = str(tmp_path / "conv")
    tcc.convert_hf_checkpoint(hf_dir, out, "w4a8kv4", 128, device="cpu")
    jargs = jcc.load_packed_config(out)
    _, jparams = jloader.load_model(hf_dir, jargs.quant)
    _assert_bit_equal(tcc.load_packed_checkpoint(out, tcc.load_packed_config(out), "cpu"),
                      jparams)
    # calibrated: a byte corpus (BOS 256) over a 384-id model writes a
    # packed checkpoint of other codes than RTN's
    bytes_cfg = dict(CFG, vocab_size=384)
    model = _write_hf(tmp_path / "bytes", bytes_cfg, _hf_state(bytes_cfg, np.random.default_rng(1)))
    (tmp_path / "corpus").mkdir()
    np.random.default_rng(0).integers(0, 256, 4096).astype(np.uint8).tofile(
        tmp_path / "corpus" / "train.bin")
    rtn, cal = str(tmp_path / "rtn"), str(tmp_path / "cal")
    tcc.convert_hf_checkpoint(model, rtn, "w4a8kv4", 128, device="cpu")
    tcc.convert_hf_checkpoint(model, cal, "w4a8kv4", 128, calib_corpus=str(tmp_path / "corpus"),
                              calib_windows=2, calib_seqlen=32, device="cpu")
    got = tcc.load_packed_checkpoint(cal, tcc.load_packed_config(cal), "cpu")
    want = tcc.load_packed_checkpoint(rtn, tcc.load_packed_config(rtn), "cpu")
    assert got.layers.qkv.qweight.shape == want.layers.qkv.qweight.shape
    assert not torch.equal(got.layers.qkv.qweight, want.layers.qkv.qweight)
    # a corpus whose BOS lies past the vocabulary is refused
    with pytest.raises(ValueError, match="past the vocabulary"):
        tcc.convert_hf_checkpoint(hf_dir, out, "w4a8kv4", calib_corpus=str(tmp_path / "corpus"),
                                  calib_windows=2, calib_seqlen=32, device="cpu")


# ---------------------------------------------------------------------------
# engines from a checkpoint directory
# ---------------------------------------------------------------------------

def _run(engine, sp_cls, prompts=None, text=None, **sp):
    reqs = {}
    for i, p in enumerate(prompts or []):
        engine.add_request(f"r{i}", prompt_token_ids=p, sampling_params=sp_cls(**sp))
    for i, t in enumerate(text or []):
        engine.add_request(f"t{i}", prompt=t, sampling_params=sp_cls(**sp))
    steps = 0
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                reqs[out.request_id] = (out.prompt_token_ids, out.outputs[0])
        steps += 1
        assert steps < 100, "engine did not converge"
    return reqs


def _engines(model, **kw):
    """(the JAX package's engine, the port's) from one directory."""
    j = JEngineArgs(model=model, **dict(ENGINE, **kw)).build_engine()
    t = EngineArgs(model=model, device="cpu", **dict(ENGINE, **kw)).build_engine()
    return j, t


# pinned away from near-ties of the tiny model's logits (ROADMAP queue 3)
PROMPT_SEED = 0


def _prompts(n=3):
    r = np.random.default_rng(PROMPT_SEED)
    return [r.integers(3, CFG["vocab_size"], int(L)).tolist() for L in r.integers(5, 40, n)]


@pytest.fixture(scope="module")
def packed_dir(hf_dir, tmp_path_factory):
    jargs, jparams = jloader.load_model(hf_dir, JQ.from_precision("w4a8kv4"))
    out = str(tmp_path_factory.mktemp("packed"))
    jcc.save_packed_checkpoint(jparams, jargs, out)
    return out


@pytest.mark.parametrize("source", ["hf", "packed"])
def test_engines_give_the_same_greedy_streams(hf_dir, packed_dir, source):
    kw = dict(quant_path=packed_dir) if source == "packed" else {}
    jeng, teng = _engines(hf_dir, **kw)
    assert teng.tokenizer is not None and jeng.tokenizer is not None
    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    want = _run(jeng, JSP, _prompts(), **sp)
    got = _run(teng, TSP, _prompts(), **sp)
    assert len(want) == 3
    assert {k: v[1]["token_ids"] for k, v in got.items()} == \
        {k: v[1]["token_ids"] for k, v in want.items()}


def test_engine_args_checkpoint_paths(hf_dir):
    """hf_config serves random weights only; quant_path, the tokenizer
    flags and trust_remote_code are taken; AsyncEngineArgs parses the JAX
    package's async flags."""
    import argparse

    with pytest.raises(ValueError, match="directory"):
        EngineArgs(hf_config=CFG, device="cpu", **ENGINE).build_engine()
    p = AsyncEngineArgs.add_cli_args(argparse.ArgumentParser())
    a = p.parse_args(["--model", hf_dir, "--quant-path", "q", "--tokenizer", "t",
                      "--tokenizer-mode", "slow", "--engine-use-ray", "--max-log-len", "7"])
    ea = AsyncEngineArgs.from_cli_args(a)
    assert (ea.quant_path, ea.tokenizer, ea.tokenizer_mode, ea.engine_use_ray,
            ea.max_log_len) == ("q", "t", "slow", True, 7)
    ea._refuse_unported()


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def _text_outputs(jeng, teng, **sp):
    want = _run(jeng, JSP, text=[TEXT], **sp)
    got = _run(teng, TSP, text=[TEXT], **sp)
    return want["t0"], got["t0"]


@pytest.fixture(scope="module")
def text_engines(hf_dir):
    return _engines(hf_dir)


@pytest.fixture(scope="module")
def stream(text_engines):
    """The greedy ids the text prompt gives (both engines agree)."""
    (jids, jout), (tids, tout) = _text_outputs(
        *text_engines, max_tokens=6, temperature=0.0, ignore_eos=True)
    assert tids == jids and tout["token_ids"] == jout["token_ids"]
    return tout["token_ids"]


def test_text_prompt_ids_and_output_text(text_engines, stream):
    (jids, jout), (tids, tout) = _text_outputs(
        *text_engines, max_tokens=6, temperature=0.0, ignore_eos=True)
    assert tids == jids == [VOCAB.index(w) for w in TEXT.split()]
    assert tout == jout
    assert tout["text"].split() == [VOCAB[i] for i in stream if i >= len(_SPECIAL)]


def test_eos_stops_both(hf_dir, tmp_path, stream):
    assert stream[2] >= len(_SPECIAL) and stream[2] not in stream[:2]
    eos = VOCAB[stream[2]]
    tok = _save_tokenizer(tmp_path / "tok_eos", eos=eos)
    jeng, teng = _engines(hf_dir, tokenizer=tok)
    assert teng.tokenizer.eos_token_id == stream[2]
    want, got = _text_outputs(jeng, teng, max_tokens=6, temperature=0.0)
    assert got == want
    assert got[1]["token_ids"] == stream[:3]
    assert got[1]["finish_reason"] == "stop"
    assert got[1]["text"].split() == [VOCAB[i] for i in stream[:2]]


def test_stop_string_trims_both(text_engines, stream):
    stop = VOCAB[stream[3]]
    assert stream[3] >= len(_SPECIAL) and stream[3] not in stream[:3]
    want, got = _text_outputs(*text_engines, max_tokens=6, temperature=0.0,
                              ignore_eos=True, stop=[stop])
    assert got == want
    assert got[1]["token_ids"] == stream[:4]
    assert got[1]["text"].split() == [VOCAB[i] for i in stream[:3]]


@pytest.mark.parametrize("skip", [True, False])
def test_skip_special_tokens(hf_dir, tmp_path, stream, skip):
    special = VOCAB[stream[1]]
    tok = _save_tokenizer(tmp_path / "tok_special", special=[special])
    jeng, teng = _engines(hf_dir, tokenizer=tok)
    want, got = _text_outputs(jeng, teng, max_tokens=6, temperature=0.0,
                              ignore_eos=True, skip_special_tokens=skip)
    assert got == want
    assert (special in got[1]["text"].split()) is not skip


def test_tokenizer_mode_slow_and_no_tokenizer(hf_dir, tmp_path, stream):
    jeng, teng = _engines(hf_dir, tokenizer_mode="slow")
    assert type(jeng.tokenizer) is type(teng.tokenizer)
    want, got = _text_outputs(jeng, teng, max_tokens=6, temperature=0.0, ignore_eos=True)
    assert got == want and got[1]["token_ids"] == stream
    # a directory without tokenizer files: token ids only, on both sides
    bare = tmp_path / "bare"
    bare.mkdir()
    for f in ("config.json", "model.safetensors"):
        shutil.copy(os.path.join(hf_dir, f), bare / f)
    jeng, teng = _engines(str(bare))
    assert jeng.tokenizer is None and teng.tokenizer is None


# ---------------------------------------------------------------------------
# conversation templates and e2e_generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jconv._REGISTRY))
def test_conversation_templates_match(name):
    def render(mod):
        c = mod.get_conv_template(name)
        c.set_system_message(c.system or "Be brief.")
        c.append_message(c.roles[0], "Hi")
        c.append_message(c.roles[1], "Hello")
        c.append_message(c.roles[0], "Bye")
        c.append_message(c.roles[1], None)
        return c.get_prompt(), c.stop_str, c.roles

    assert sorted(tconv._REGISTRY) == sorted(jconv._REGISTRY)
    assert render(tconv) == render(jconv)
    for path in ("/m/Llama-3-8B-Instruct", "/m/llama2-7b", "/m/vicuna-7b", "/m/Qwen2-7B",
                 "/m/Yi-34B", "/m/Mixtral-8x7B", "/m/VILA1.5-3b", "/m/llava-v1.5", "/m/gpt2"):
        assert tconv.get_conv_template_name(path) == jconv.get_conv_template_name(path)


def test_e2e_generation_prints_what_the_jax_entry_point_prints(hf_dir, monkeypatch, capsys):
    common = ["--model", hf_dir, "--max-tokens", "4", "--temperature", "0",
              "--block-size", "16", "--num-device-pages", "32", "--max-model-len", "128",
              "--max-num-batched-tokens", "128", "--max-num-seqs", "4"]

    def blocks(main, argv):
        monkeypatch.setattr(sys, "argv", ["e2e"] + argv)
        main()
        out = capsys.readouterr().out
        return [b for b in out.split("\n=== ")[1:]], out

    want, _ = blocks(je2e.main, common)
    got, out = blocks(te2e.main, common + ["--device", "cpu"])
    assert len(got) == len(te2e.DEFAULT_PROMPTS) == 4
    assert [b.rsplit("\nfinished", 1)[0] for b in got] == \
        [b.rsplit("\nfinished", 1)[0] for b in want]
    assert "finished 4 requests" in out


# ---------------------------------------------------------------------------
# the benchmarking device-feed decode
# ---------------------------------------------------------------------------

def test_device_feed_chain_equals_the_greedy_streams(hf_dir, monkeypatch):
    """benchmarking=True: while the decode batch keeps its order and width
    the sampled ids stay where they were sampled and are the next step's
    input; the engine sees placeholder ids. The chain of those ids equals a
    normal engine's greedy streams, and no decode step reads them back."""
    from qserve_tpu_torch.entrypoints import benchmark
    from qserve_tpu_torch.worker import model_runner as mr

    sp = dict(max_tokens=8, temperature=0.0, ignore_eos=True)
    normal = EngineArgs(model=hf_dir, device="cpu", **ENGINE).build_engine()
    want = _run(normal, TSP, _prompts(), **sp)

    feed = EngineArgs(model=hf_dir, device="cpu", benchmarking=True, **ENGINE).build_engine()
    runner = feed.worker.model_runner
    assert runner.benchmarking and not normal.worker.model_runner.benchmarking
    real_sample, real_decode, real_forward = runner._sample, runner.execute_decode, mr.llama.decode
    sampled, steps, fed, reads, in_decode = [], [], [], [], [False]

    def sample(*a, **k):
        sampled.append(real_sample(*a, **k))
        return sampled[-1]

    def forward(params, cache, token_ids, *a, **k):
        fed.append(token_ids is runner._prev_toks)
        return real_forward(params, cache, token_ids, *a, **k)

    def decode(md, ce):
        in_decode[0] = True
        out = real_decode(md, ce)
        in_decode[0] = False
        assert runner._prev_toks is sampled[-1]
        steps.append((runner._prev_order, runner._prev_toks.clone()))
        return out

    for meth in ("cpu", "numpy", "tolist", "item"):
        def watch(self, *a, _real=getattr(torch.Tensor, meth), _meth=meth, **k):
            if any(self is t for t in sampled):
                reads.append((_meth, in_decode[0]))
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, meth, watch)
    monkeypatch.setattr(runner, "_sample", sample)
    monkeypatch.setattr(runner, "execute_decode", decode)
    monkeypatch.setattr(mr.llama, "decode", forward)
    got = _run(feed, TSP, _prompts(), **sp)
    monkeypatch.undo()

    assert fed == [False] + [True] * 6  # the first decode step takes host ids
    assert reads and not any(d for _, d in reads), reads  # prefill reads, decode never
    assert all(out["token_ids"][1:] == [0] * 7 for _, out in got.values())
    req = {sid: g.request_id for sid, (g, _) in feed._seq_index.items()}
    chain = {rid: [out["token_ids"][0]] for rid, (_, out) in got.items()}
    for order, toks in steps:
        for i, sid in enumerate(order):
            chain[req[sid]].append(int(toks[i]))
    assert chain == {rid: out["token_ids"] for rid, (_, out) in want.items()}

    # the benchmark entry point passes the flag through and records it
    rows = benchmark.run(feed, CFG["vocab_size"], batch=2, prompt_len=12, gen_len=4,
                         rounds=1, csv_path=None)
    assert rows[0]["device_feed"] is True and rows[0]["tokens_per_s"] > 0
