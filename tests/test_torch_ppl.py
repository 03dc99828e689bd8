"""Port parity: teacher-forced scoring, the float reference forward and the
perplexity harness (qserve_tpu_torch/models/llama.py teacher_forced_nll,
reference_forward_float; qserve_tpu_torch/eval/ppl.py) against the JAX
package's, on tests/test_ppl.py's tiny geometry. The JAX package quantizes
its random float weights; the port receives the same quantized params
through params_from_numpy.

Tolerances: `count` is exact. The NLL sums (~63 tokens x ~5.5 nats) agree
within NLL_RTOL relative: both sides round the same values to bf16 and int8
at the same places, but their f32 reductions may land an ulp apart and move
a bf16 element to its neighbour. The f32 reference forwards agree within
1e-5 (atol and rtol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.config import QuantSpec as JQuantSpec
from qserve_tpu.eval.ppl import evaluate_ppl as j_evaluate_ppl
from qserve_tpu.models import llama as jllama
from qserve_tpu_torch.config import QuantSpec as TQuantSpec
from qserve_tpu_torch.convert.from_jax import params_from_numpy
from qserve_tpu_torch.eval.ppl import evaluate_ppl
from qserve_tpu_torch.models import llama as tllama
import torch_port_util  # noqa: F401  (one torch thread a test process)

TINY = dict(
    vocab_size=256, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
)
NLL_RTOL = 1e-3  # measured: at most 1.7e-4 over the 8 cases
PRECISIONS = [("w16a16kv8", -1), ("w4a8kv4", -1), ("w4a8kv4", 128), ("w8a8kv8", -1)]


@pytest.fixture(scope="module")
def float_params():
    args16 = jllama.LlamaArgs(**TINY, quant=JQuantSpec.from_precision("w16a16kv8"))
    return jllama.random_float_params(jax.random.PRNGKey(0), args16, scale=0.05)


def _pair(fp, precision, group_size):
    """(JAX args, JAX params, port args, port params) of one precision."""
    jargs = jllama.LlamaArgs(**TINY, quant=JQuantSpec.from_precision(precision, group_size))
    targs = tllama.LlamaArgs(**TINY, quant=TQuantSpec.from_precision(precision, group_size))
    jparams = jllama.quantize_params(fp, jargs)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jargs, jparams, targs, tparams


@pytest.fixture(scope="module")
def pairs(float_params):
    return {spec: _pair(float_params, *spec) for spec in PRECISIONS}


def _tokens(seed, n, T):
    tokens = np.zeros(T, np.int32)
    tokens[:n] = np.random.default_rng(seed).integers(0, TINY["vocab_size"], n)
    return tokens


@pytest.mark.parametrize("simulate_kv_quant", [False, True], ids=["kv-exact", "kv-sim"])
@pytest.mark.parametrize("spec", PRECISIONS, ids=lambda s: f"{s[0]}-g{s[1]}")
def test_teacher_forced_nll_matches_jax(pairs, spec, simulate_kv_quant):
    jargs, jparams, targs, tparams = pairs[spec]
    tokens = _tokens(0, 60, 64)
    jn, jc = jllama.teacher_forced_nll(
        jparams, jnp.asarray(tokens), jnp.int32(60), jargs, row_chunk=16,
        simulate_kv_quant=simulate_kv_quant)
    tn, tc = tllama.teacher_forced_nll(
        tparams, torch.from_numpy(tokens), 60, targs, row_chunk=16,
        simulate_kv_quant=simulate_kv_quant)
    assert tc == int(jc) == 59
    assert tn.dtype == torch.float32 and tn.shape == ()
    np.testing.assert_allclose(float(tn), float(jn), rtol=NLL_RTOL)


def test_kv_simulation_changes_the_score(pairs):
    """KV4 round trips move the loss: the flag is not a no-op."""
    _, _, targs, tparams = pairs[("w4a8kv4", -1)]
    tokens = torch.from_numpy(_tokens(0, 64, 64))
    a, _ = tllama.teacher_forced_nll(tparams, tokens, 64, targs, row_chunk=16)
    b, _ = tllama.teacher_forced_nll(tparams, tokens, 64, targs, row_chunk=16,
                                     simulate_kv_quant=True)
    assert float(a) != float(b)


def test_length_mask(pairs):
    """Garbage in the padded tail changes neither side's score, and the two
    sides agree on it."""
    jargs, jparams, targs, tparams = pairs[("w16a16kv8", -1)]
    tokens = _tokens(1, 40, 64)
    tokens2 = tokens.copy()
    tokens2[40:] = np.random.default_rng(2).integers(0, 256, 24)
    a, ca = tllama.teacher_forced_nll(tparams, torch.from_numpy(tokens), 40, targs, 16)
    b, cb = tllama.teacher_forced_nll(tparams, torch.from_numpy(tokens2), 40, targs, 16)
    assert ca == cb == 39
    assert float(a) == float(b)
    jn, _ = jllama.teacher_forced_nll(jparams, jnp.asarray(tokens2), jnp.int32(40), jargs,
                                      row_chunk=16)
    np.testing.assert_allclose(float(b), float(jn), rtol=NLL_RTOL)
    # length 1 scores nothing
    z, cz = tllama.teacher_forced_nll(tparams, torch.from_numpy(tokens), 1, targs, 16)
    assert cz == 0 and float(z) == 0.0


@pytest.mark.parametrize("max_windows", [None, 1])
def test_evaluate_ppl_windows_match_jax(pairs, max_windows):
    """300 tokens at seqlen 128: 2 windows (the tail of 44 is dropped), or 1."""
    jargs, jparams, targs, tparams = pairs[("w4a8kv4", -1)]
    ids = np.random.default_rng(3).integers(0, 256, 300).astype(np.int32)
    got = evaluate_ppl(tparams, targs, ids, seqlen=128, max_windows=max_windows,
                       row_chunk=32)
    want = j_evaluate_ppl(jparams, jargs, ids, seqlen=128, max_windows=max_windows,
                          row_chunk=32)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_evaluate_ppl_short_corpus(pairs):
    """A corpus shorter than one window is one (padded) window; an empty
    one raises."""
    jargs, jparams, targs, tparams = pairs[("w8a8kv8", -1)]
    ids = np.random.default_rng(4).integers(0, 256, 50).astype(np.int32)
    got = evaluate_ppl(tparams, targs, ids, seqlen=128, row_chunk=32)
    want = j_evaluate_ppl(jparams, jargs, ids, seqlen=128, row_chunk=32)
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)
    with pytest.raises(ValueError):
        evaluate_ppl(tparams, targs, ids[:0], seqlen=128, max_windows=0, row_chunk=32)


def test_reference_forward_float_matches_jax(float_params):
    """f32 end to end on both sides (the port's plain attention)."""
    jargs = jllama.LlamaArgs(**TINY, quant=JQuantSpec.from_precision("w16a16kv8"))
    targs = tllama.LlamaArgs(**TINY, quant=TQuantSpec.from_precision("w16a16kv8"))
    tokens = np.random.default_rng(5).integers(0, 256, 48).astype(np.int32)
    want = np.asarray(jllama.reference_forward_float(float_params, jargs, jnp.asarray(tokens)))
    fp_np = jax.tree.map(np.asarray, float_params)
    got = tllama.reference_forward_float(fp_np, targs, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (48, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_nll_matches_float_reference(pairs, float_params):
    """The port's W16A16 score against the port's own f32 oracle (the JAX
    package's test_ppl property): within 2% relative."""
    _, _, targs, tparams = pairs[("w16a16kv8", -1)]
    tokens = torch.from_numpy(_tokens(0, 64, 64))
    nll, cnt = tllama.teacher_forced_nll(tparams, tokens, 64, targs, row_chunk=16)
    logits = tllama.reference_forward_float(jax.tree.map(np.asarray, float_params),
                                            targs, tokens)
    logp = torch.log_softmax(logits, dim=-1)
    ref = -logp[:-1].gather(1, tokens[1:, None].long()).sum()
    assert cnt == 63
    assert abs(float(nll) - float(ref)) / float(ref) < 0.02
