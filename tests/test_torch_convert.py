"""Port parity of checkpoint conversion (qserve_tpu_torch/convert/
checkpoint_converter.py): the calibrated convert_hf_checkpoint and
convert_deepcompressor_checkpoint against the JAX package's, on a tiny HF
directory and fabricated DeepCompressor output written in tmp_path from a
numpy seed.

  * Calibrated conversion: given the JAX package's optimized float params,
    the port quantizes to the JAX package's packed leaves bit for bit. When
    each side optimizes for itself, their calibration stats differ by bf16
    neighbour flips (tests/test_torch_quant_optimize.py), so the packed
    checkpoints agree within a tolerance: CODE_SHARE of the W4 / W8 codes
    equal, and the served models' teacher-forced NLL within 1e-3.
  * DeepCompressor conversion: the packed files equal the JAX package's bit
    for bit at per-channel, g128 and W8, including a g128 artifact whose s2
    exceeds 127 and one on the signed lattice; the two lattice behaviours
    the port keeps from the JAX package are pinned here (ROADMAP, standing
    divergences).
"""

import numpy as np
import pytest
import torch

from qserve_tpu.config import QuantSpec as JQ
from qserve_tpu.convert import checkpoint_converter as jcc
from qserve_tpu.models import loader as jloader
from qserve_tpu.quant import optimize as joptimize
from qserve_tpu_torch.convert import checkpoint_converter as tcc
from qserve_tpu_torch.models import llama as tllama
from qserve_tpu_torch.quant import qoq
from qserve_tpu_torch.utils import weight_utils as wu
from test_torch_checkpoint import CFG, _assert_bit_equal, _hf_state, _write_hf
import torch_port_util  # noqa: F401  (one torch thread a test process)

# a byte-level vocabulary with BOS 256, as load_calib_windows draws
CFG_BYTES = dict(CFG, vocab_size=384)
CALIB = dict(calib_windows=4, calib_seqlen=64)
CODE_SHARE = 0.95  # measured 0.963-0.984; the NLL gap 1.3e-4 to 2.8e-4
PRECISIONS = [("w4a8kv4", -1), ("w4a8kv4", 128), ("w8a8kv8", -1)]
IDS = lambda s: f"{s[0]}-g{s[1]}"  # noqa: E731


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    state = _hf_state(CFG_BYTES, np.random.default_rng(0))
    # outlier channels in the embedding (tests/test_quant_optimize.py's regime)
    boost = np.where(np.random.default_rng(1).random(CFG_BYTES["hidden_size"]) < 0.05, 30, 1)
    state["model.embed_tokens.weight"] *= boost.astype(np.float32)[None, :]
    return _write_hf(tmp_path_factory.mktemp("hf_bytes"), CFG_BYTES, state)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    np.random.default_rng(2).integers(0, 256, 50000).astype(np.uint8).tofile(d / "train.bin")
    return str(d)


@pytest.fixture(scope="module")
def jax_calibrated(hf_dir, corpus, tmp_path_factory):
    """{spec: JAX package's calibrated packed directory}."""
    out = {}
    for precision, gs in PRECISIONS:
        d = str(tmp_path_factory.mktemp(f"j_{precision}_{gs}"))
        jcc.convert_hf_checkpoint(hf_dir, d, precision, gs, calib_corpus=corpus, **CALIB)
        out[(precision, gs)] = d
    return out


def _load(d):
    return tcc.load_packed_checkpoint(d, tcc.load_packed_config(d), "cpu")


@pytest.mark.parametrize("spec", PRECISIONS, ids=IDS)
def test_calibrated_bit_for_bit_given_jax_float_params(hf_dir, corpus, jax_calibrated, spec):
    precision, gs = spec
    jq = JQ.from_precision(precision, gs)
    jargs = jloader.args_from_config_dict(jloader.load_hf_config_dict(hf_dir), jq)
    fp = jloader.load_float_params_from_hf(hf_dir, jargs)
    calib = joptimize.load_calib_windows(corpus, n_windows=4, seqlen=64)
    fp_opt = joptimize.optimize_float_params(fp, jargs, calib)
    targs = tcc.load_packed_config(jax_calibrated[spec])
    got = tllama.quantize_params(
        {k: (v if k != "layers" else [{n: np.asarray(x) for n, x in fl.items()} for fl in v])
         for k, v in fp_opt.items()}, targs, device="cpu")
    _assert_bit_equal(got, _load(jax_calibrated[spec]))


def _codes(p):
    """The integer codes of every linear: W4 nibbles or W8 bytes."""
    out = []
    for name in ("qkv", "o", "gate_up", "down"):
        lin = getattr(p.layers, name)
        out.append(lin.qweight.reshape(-1))
    return torch.cat(out)


def _nll(p, args, toks):
    nll, _ = tllama.teacher_forced_nll(p, torch.from_numpy(toks), len(toks), args, 16)
    return float(nll)


@pytest.mark.parametrize("spec", PRECISIONS, ids=IDS)
def test_calibrated_port_against_jax(hf_dir, corpus, jax_calibrated, tmp_path, spec):
    precision, gs = spec
    out = str(tmp_path / "t")
    tcc.convert_hf_checkpoint(hf_dir, out, precision, gs, calib_corpus=corpus, device="cpu",
                              **CALIB)
    targs = tcc.load_packed_config(out)
    got, want = _load(out), _load(jax_calibrated[spec])
    share = (_codes(got) == _codes(want)).float().mean().item()
    assert share >= CODE_SHARE, share
    toks = np.random.default_rng(3).integers(0, 256, 64).astype(np.int32)
    np.testing.assert_allclose(_nll(got, targs, toks), _nll(want, targs, toks), rtol=1e-3)
    # the optimized model differs from plain RTN
    rtn = str(tmp_path / "rtn")
    tcc.convert_hf_checkpoint(hf_dir, rtn, precision, gs, device="cpu")
    assert not torch.equal(_codes(_load(rtn)), _codes(got))


# ---------------------------------------------------------------------------
# DeepCompressor output
# ---------------------------------------------------------------------------

LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
           "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def _artifact(state, kind, group_size=128, wide_s2=False, signed=False):
    """DeepCompressor-style model.pt / scale.pt dicts from HF weights:
    fake-quantized weights [OC, IC] and their scales, on the lattice the
    converter reads. per-channel: asymmetric min/max with a signed zero;
    g128: the port's two-level quantizer's (q, s2, z2, s1), optionally with
    one group of s2 = 200 (z2 -128, codes 0/1) in every linear, or every
    code moved onto the signed lattice (q - 8 with z2 + 8 s2, so that the
    fake weight is unchanged); W8: symmetric per channel."""
    model, scales = {}, {}
    for name, w in state.items():
        t = torch.from_numpy(np.asarray(w, np.float32))
        if not any(f".{lin}." in name for lin in LINEARS):
            model[name] = t
            continue
        key = name  # "<prefix>.weight"
        if kind == "w4chn":
            mx, mn = t.amax(dim=1, keepdim=True), t.amin(dim=1, keepdim=True)
            s1 = ((mx - mn) / 15.0).clamp(min=1e-8)
            zero_u = (-mn / s1).round().clamp(0, 15)
            q = (t / s1 + zero_u).round().clamp(0, 15)
            model[name] = (q - zero_u) * s1
            scales[key + ".scale"] = s1[:, 0]
            scales[key + ".zero"] = zero_u[:, 0] - 8.0
        elif kind == "w8":
            s1 = (t.abs().amax(dim=1) / 127.0).clamp(min=1e-8)
            q = (t / s1[:, None]).round().clamp(-128, 127)
            model[name] = q * s1[:, None]
            scales[key + ".scale"] = s1
        else:
            p = qoq.quantize_weight_per_group(t.T.contiguous(), group_size)  # [K, N]
            K, N = p.qweight.shape
            G = K // group_size
            q = p.qweight.to(torch.float32).reshape(G, group_size, N)
            s2 = (p.s2_scale.to(torch.int32) & 0xFF).to(torch.float32)
            z2 = p.s2_zero.to(torch.float32)
            if wide_s2:
                q[0, :, 0] = (q[0, :, 0] > 7).float()
                s2[0, 0], z2[0, 0] = 200.0, -128.0
            if signed:
                q, z2 = q - 8.0, z2 + 8.0 * s2
            w8 = q * s2[:, None, :] + z2[:, None, :]
            model[name] = (w8.reshape(K, N) * p.s1_scale[None, :]).T.contiguous()
            scales[key + ".scale"] = p.s1_scale
            scales[key + ".scale2"] = s2
            scales[key + ".zero"] = z2
    return model, scales


DC_CASES = [
    ("w4a8kv4", -1, "w4chn", {}),
    ("w4a8kv4", 128, "w4grp", {}),
    ("w4a8kv4", 128, "w4grp", dict(wide_s2=True)),
    ("w4a8kv4", 128, "w4grp", dict(signed=True)),
    ("w8a8kv8", -1, "w8", {}),
]


@pytest.fixture(scope="module")
def hf_state():
    return _hf_state(CFG, np.random.default_rng(4))


@pytest.fixture(scope="module")
def hf_plain(hf_state, tmp_path_factory):
    return _write_hf(tmp_path_factory.mktemp("hf_plain"), CFG, hf_state)


def _write_artifact(d, model, scales):
    d.mkdir(parents=True, exist_ok=True)
    torch.save(model, d / "model.pt")
    torch.save(scales, d / "scale.pt")
    return str(d)


@pytest.mark.parametrize("precision,gs,kind,extra", DC_CASES,
                         ids=["w4chn", "g128", "g128-s2-200", "g128-signed", "w8"])
def test_deepcompressor_bit_for_bit(hf_state, hf_plain, tmp_path, precision, gs, kind, extra):
    art = _write_artifact(tmp_path / "art", *_artifact(hf_state, kind, **extra))
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jcc.convert_deepcompressor_checkpoint(hf_plain, art, jd, precision, gs)
    tcc.convert_deepcompressor_checkpoint(hf_plain, art, td, precision, gs)
    want = wu.read_safetensors(f"{jd}/model.safetensors")
    got = wu.read_safetensors(f"{td}/model.safetensors")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    args = tcc.load_packed_config(td)
    params = tcc.load_packed_checkpoint(td, args, "cpu")
    assert args.quant.precision == precision and args.quant.group_size == gs
    toks = np.random.default_rng(5).integers(0, CFG["vocab_size"], 32).astype(np.int32)
    assert np.isfinite(_nll(params, args, toks))


def _level2(td, layer=0, name="qkv"):
    """Layer `layer`'s level-2 int8 weights [K, N] of the packed linear."""
    from qserve_tpu_torch.quant import packing

    p = getattr(_load(td).layers, name).layer(layer)
    return qoq.pergroup_level2_int8(qoq.PerGroupW4(
        packing.unpack_w4(p.qweight), p.s2_scale, p.s2_zero, p.s1_scale), 128)


def test_deepcompressor_keeps_s2_above_127(hf_state, hf_plain, tmp_path):
    """s2 = 200 is stored as the byte -56 (np.clip(s2, 1, 255).astype(int16)
    .astype(int8)) and read back as 200 (uint8 in the int8 carrier): the
    level-2 weights equal the artifact's q * 200 - 128."""
    model, scales = _artifact(hf_state, "w4grp", wide_s2=True)
    td = str(tmp_path / "t")
    tcc.convert_deepcompressor_checkpoint(hf_plain, _write_artifact(tmp_path / "a", model, scales),
                                          td, "w4a8kv4", 128)
    p = _load(td).layers.qkv.layer(0)
    assert int(p.s2_scale[0, 0]) == -56
    w8 = _level2(td)[:128, 0].to(torch.int32)  # q_proj's column 0, group 0
    s1 = scales["model.layers.0.self_attn.q_proj.weight.scale"][0]
    fake = model["model.layers.0.self_attn.q_proj.weight"][0, :128]
    assert torch.equal(w8, torch.round(fake / s1).to(torch.int32))
    assert set(w8.tolist()) <= {-128, 72}


def test_deepcompressor_signed_lattice_shifts_codes(hf_state, hf_plain, tmp_path):
    """Pinned (ROADMAP, standing divergences): when any per-group code of a
    tensor comes out negative, the converter adds 8 to every code of that
    tensor and keeps z2 as stored, in both packages. A signed-lattice
    artifact (w8 = q * s2 + z2 with q in [-8, 7]) therefore serves
    w8 + 8 * s2 (wrapped to int8), not its own fake weights."""
    model, scales = _artifact(hf_state, "w4grp", signed=True)
    td = str(tmp_path / "t")
    tcc.convert_deepcompressor_checkpoint(hf_plain, _write_artifact(tmp_path / "a", model, scales),
                                          td, "w4a8kv4", 128)
    pre = "model.layers.0.self_attn.q_proj.weight"
    w8_art = torch.round(model[pre].T / scales[pre + ".scale"][None, :]).to(torch.int32)
    s2 = scales[pre + ".scale2"].to(torch.int32)  # [G, N]
    shifted = w8_art + 8 * s2.repeat_interleave(128, dim=0)
    want = ((shifted + 128) & 0xFF) - 128
    got = _level2(td)[:, : w8_art.shape[1]].to(torch.int32)
    assert torch.equal(got, want)
    assert not torch.equal(got, w8_art)


# ---------------------------------------------------------------------------
# the port's scripts, on the CPU
# ---------------------------------------------------------------------------


def _script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def byte_corpus(corpus):
    """The corpus with a val split too (as build_tiny_corpus.py writes)."""
    np.random.default_rng(6).integers(0, 256, 1024).astype(np.uint8).tofile(
        f"{corpus}/val.bin")
    return corpus


def test_convert_checkpoint_script(hf_dir, byte_corpus, tmp_path, capsys):
    mod = _script("convert_checkpoint_torch")
    out = str(tmp_path / "cal")
    mod.main(["--model-path", hf_dir, "--output-path", out, "--group-size", "128",
              "--calib-corpus", byte_corpus, "--calib-windows", "2", "--calib-seqlen", "64",
              "--device", "cpu"])
    assert tcc.load_packed_config(out).quant.group_size == 128
    art = _write_artifact(tmp_path / "art", *_artifact(
        _hf_state(CFG_BYTES, np.random.default_rng(0)), "w8"))
    mod.main(["--model-path", hf_dir, "--quant-path", art, "--output-path", str(tmp_path / "dc"),
              "--precision", "w8a8kv8"])
    assert _load(str(tmp_path / "dc")).layers.qkv.qweight.dtype == torch.int8
    with pytest.raises(SystemExit):  # a calibration corpus with DeepCompressor scales
        mod.main(["--model-path", hf_dir, "--quant-path", art, "--output-path", out,
                  "--calib-corpus", byte_corpus])


def test_eval_tiny_ppl_script(hf_dir, byte_corpus):
    results = _script("eval_tiny_ppl_torch").main(
        [hf_dir, byte_corpus, "--seqlen", "128", "--windows", "2", "--optimize",
         "--calib-windows", "2", "--device", "cpu"])
    assert len(results) == 6 and all(np.isfinite(v) for v in results.values())


@pytest.mark.parametrize("kind", ["w4chn", "w4grp", "w8"])
def test_deepcompressor_roundtrip_script(hf_dir, byte_corpus, kind, capsys):
    """The synthetic scales are RTN's: the import recovers RTN's codes."""
    ppl_dc, ppl_rtn = _script("deepcompressor_roundtrip_torch").main(
        [hf_dir, byte_corpus, "--kind", kind, "--windows", "2", "--seqlen", "128",
         "--device", "cpu"])
    assert ppl_dc == ppl_rtn
    assert "codes equal to RTN's: 1.000000" in capsys.readouterr().out
