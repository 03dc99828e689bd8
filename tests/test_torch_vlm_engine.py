"""Port parity of the VLM engine: the port's LLMEngine over a
VLMModelRunner against the JAX package's, on the same tiny VILA weights
(tests/test_vlm_engine.py's geometry: f32 tower and projector, W8A8KV8
LLM), the same PIL images and the same prompts: image requests in a batch
with a text-only one, an n = 2 image prompt, a chunked image prompt whose
markers straddle the chunk boundary (port-chunked against JAX-chunked:
exactness is pinned only between identical paths, ROADMAP queue 3), and a
continuation chunk that finds no cached embeddings and re-encodes. Greedy
streams are equal on these pinned inputs, away from near-ties. Also the
engine side: admission expands only requests with `images`, a text-only
batch takes the dense runner, EngineArgs(run_vlm=True) builds the random
VLM of the JAX package's geometry with mixed steps off, and load_vlm_model
reads both directory layouts as the JAX loader does."""

import json
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")  # tokenizers from local directories only

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qserve_tpu.config import CacheConfig as JCacheConfig  # noqa: E402
from qserve_tpu.config import QuantSpec as JQ  # noqa: E402
from qserve_tpu.config import SchedulerConfig as JSchedulerConfig  # noqa: E402
from qserve_tpu.engine.arg_utils import EngineArgs as JEngineArgs  # noqa: E402
from qserve_tpu.engine.llm_engine import LLMEngine as JLLMEngine  # noqa: E402
from qserve_tpu.models import loader as jloader  # noqa: E402
from qserve_tpu.models import vila as jvila  # noqa: E402
from qserve_tpu.sampling_params import SamplingParams as JSP  # noqa: E402
from qserve_tpu.worker.worker import Worker as JWorker  # noqa: E402
from qserve_tpu_torch.config import CacheConfig, QuantSpec, SchedulerConfig  # noqa: E402
from qserve_tpu_torch.convert.from_jax import (  # noqa: E402
    vila_args_from_jax, vila_params_from_numpy)
from qserve_tpu_torch.engine.arg_utils import EngineArgs  # noqa: E402
from qserve_tpu_torch.engine.llm_engine import LLMEngine  # noqa: E402
from qserve_tpu_torch.models import loader as tloader  # noqa: E402
from qserve_tpu_torch.models import vila as tvila  # noqa: E402
from qserve_tpu_torch.sampling_params import SamplingParams as TSP  # noqa: E402
from qserve_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX as IMG  # noqa: E402
from qserve_tpu_torch.worker.worker import Worker  # noqa: E402
from test_vlm_engine import _image, tiny_vila_args  # noqa: E402
import torch_port_util  # noqa: E402, F401  (one torch thread a test process)

PAGES = 64
# a long image prompt: 30 text ids, one image (4 markers), 8 text ids; at a
# 32-token budget its markers straddle the first chunk's end
LONG = ([(i * 3 + 1) % 100 + 4 for i in range(30)] + [IMG]
        + [(i * 7 + 5) % 100 + 4 for i in range(8)])


@pytest.fixture(scope="module")
def pair():
    jargs = tiny_vila_args("w8a8kv8")
    jparams = jvila.random_params(jax.random.PRNGKey(0), jargs)
    targs = vila_args_from_jax(jargs)
    tparams = vila_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jargs, jparams, targs, tparams


def _engines(pair, budget=256):
    """(the JAX package's VLM engine, the port's) on the same weights."""
    jargs, jparams, targs, tparams = pair
    sched = dict(max_num_batched_tokens=budget, max_num_seqs=8, max_model_len=128)
    jsc, tsc = JSchedulerConfig(**sched), SchedulerConfig(**sched)
    for sc in (jsc, tsc):  # as EngineArgs(run_vlm=True) sets it
        sc.mixed_chunk_decode = False
    jcc = JCacheConfig(block_size=16, num_device_pages=PAGES, quant=JQ.from_precision("w8a8kv8"))
    tcc = CacheConfig(block_size=16, num_device_pages=PAGES, quant=QuantSpec.from_precision("w8a8kv8"))
    j = JLLMEngine(JWorker.create_vlm(jargs, jcc, jsc, params=jparams), jsc, jcc)
    t = LLMEngine(Worker.create_vlm(targs, tcc, tsc, params=tparams, device="cpu"), tsc, tcc)
    return j, t


def _serve(engine, requests, sp_cls, max_steps=80):
    """requests: [(id, ids, image seeds, sampling kwargs)] -> {id: [streams]},
    and the kinds of the steps that ran."""
    for rid, ids, seeds, sp in requests:
        mm = {"images": [_image(s) for s in seeds]} if seeds else None
        engine.add_request(rid, prompt_token_ids=list(ids), sampling_params=sp_cls(**sp),
                           multi_modal_data=mm)
    outs, kinds, steps = {}, [], 0
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                outs[out.request_id] = [o["token_ids"] for o in out.outputs]
        kinds.append(getattr(engine, "last_step_kind", None))
        steps += 1
        assert steps < max_steps, "engine did not converge"
    return outs, kinds


def _greedy(max_tokens=4, **kw):
    return dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True, **kw)


def _both(pair, requests, budget=256):
    j, t = _engines(pair, budget)
    want, _ = _serve(j, requests, JSP)
    got, kinds = _serve(t, requests, TSP)
    return want, got, kinds, t


def test_image_and_text_batch(pair):
    """Three image prompts (one with two images, one starting on its image)
    and a text-only prompt in one prefill step, then decode: the same
    greedy streams; every page is freed."""
    reqs = [("a", [1, 2, IMG, 3, 4], [1], _greedy(5)),
            ("b", [IMG, 7, 8, 9], [2], _greedy(5)),
            ("c", [5, IMG, 6, IMG, 11], [3, 4], _greedy(5)),
            ("t", [5, 6, 7, 9, 10], [], _greedy(5))]
    want, got, kinds, t = _both(pair, reqs)
    assert set(got) == {"a", "b", "c", "t"}
    assert got == want
    assert kinds[0] == "prefill" and set(kinds[1:]) == {"decode"}
    assert t.scheduler.block_manager.get_num_free_device_pages() == PAGES
    # the same image in the same slot gives the same stream, another image another
    again, _ = _serve(_engines(pair)[1], [("a2", [1, 2, IMG, 3, 4], [1], _greedy(5)),
                                          ("a3", [1, 2, IMG, 3, 4], [9], _greedy(5))], TSP)
    assert again["a2"] == got["a"] and again["a3"] != got["a"]


def test_n2_image_prompt(pair):
    """n = 2: the extra candidate is host-sampled from the spliced prefill's
    last-token logits and forks the prompt's pages; greedy, both candidates
    equal the JAX engine's."""
    reqs = [("d", [1, 2, IMG, 3], [11], _greedy(5, n=2))]
    want, got, _, t = _both(pair, reqs)
    assert len(got["d"]) == 2 and got == want
    assert got["d"][0] == got["d"][1]
    assert t.scheduler.block_manager.get_num_free_device_pages() == PAGES


def test_chunked_image_prompt_straddling(pair):
    """At a 32-token budget the 42-token prompt runs as a first chunk (a
    prefill step that encodes and keeps the image's embeddings) and a chunk
    step whose first rows finish the image's markers; port-chunked equals
    JAX-chunked, the embeddings are released after the final chunk."""
    reqs = [("r", LONG, [7], _greedy(5))]
    want, got, kinds, t = _both(pair, reqs, budget=32)
    ids = t._seq_index[0][1].data.prompt_token_ids
    assert ids[30:34] == [IMG] * 4 and len(ids) == 42
    assert kinds[:2] == ["prefill", "chunk"] and "mixed" not in kinds
    assert got == want
    assert not t.worker.model_runner._chunk_embeds
    assert t.scheduler.block_manager.get_num_free_device_pages() == PAGES


def test_n2_chunked_image_prompt(pair):
    """n = 2 on the chunked prompt: the final chunk's logits seed the extra
    candidate."""
    reqs = [("r", LONG, [12], _greedy(4, n=2))]
    want, got, _, t = _both(pair, reqs, budget=32)
    assert len(got["r"]) == 2 and got == want
    assert not t.worker.model_runner._chunk_embeds


def test_continuation_without_cached_embeds_re_encodes(pair, monkeypatch):
    """A continuation chunk that finds no embeddings of its prompt (what a
    recompute preemption or a prefix skip leaves) runs the tower again and
    gives the stream of the uninterrupted JAX run."""
    j, t = _engines(pair, budget=32)
    want, _ = _serve(j, [("r", LONG, [7], _greedy(5))], JSP)
    runner = t.worker.model_runner
    encoded, real = [], runner._encode_prompt_images
    real_chunk = runner._execute_prefill_chunk_vlm

    def encode(pixels):
        encoded.append(len(pixels))
        return real(pixels)

    def chunk(md, cache_engine):
        runner._chunk_embeds.clear()  # the first chunk's embeddings are lost
        return real_chunk(md, cache_engine)

    monkeypatch.setattr(runner, "_encode_prompt_images", encode)
    monkeypatch.setattr(runner, "_execute_prefill_chunk_vlm", chunk)
    got, kinds = _serve(t, [("r", LONG, [7], _greedy(5))], TSP)
    assert kinds[:2] == ["prefill", "chunk"]
    assert len(encoded) == 2 and got == want
    assert not runner._chunk_embeds


def test_text_only_batch_takes_the_dense_runner(pair, monkeypatch):
    """A VLM engine serving text only never calls the image steps and gives
    the port's dense engine's streams on the same LLM weights, chunked
    too (the identical compute path: exact)."""
    from qserve_tpu_torch.worker import vlm_runner

    jargs, jparams, targs, tparams = pair
    called = []
    monkeypatch.setattr(vlm_runner.vila, "vlm_prefill", lambda *a: called.append(a))
    monkeypatch.setattr(vlm_runner.vila, "vlm_prefill_chunk", lambda *a: called.append(a))
    prompt = [(i * 5 + 3) % 120 + 4 for i in range(70)]
    sched = dict(max_num_batched_tokens=32, max_num_seqs=8, max_model_len=128)
    cc = CacheConfig(block_size=16, num_device_pages=PAGES, quant=targs.llm.quant)
    sc = SchedulerConfig(**sched)
    dense = LLMEngine(Worker.create(targs.llm, cc, sc, params=tparams.llm, device="cpu"),
                      sc, cc)
    want, _ = _serve(dense, [("r", prompt, [], _greedy(4)), ("s", [3, 4, 5], [], _greedy(4))],
                     TSP)
    _, t = _engines(pair, budget=32)
    got, kinds = _serve(t, [("r", prompt, [], _greedy(4)), ("s", [3, 4, 5], [], _greedy(4))],
                        TSP)
    assert got == want and "chunk" in kinds and not called


def test_admission_expands_only_requests_with_images(pair):
    """As in the JAX package: a request with `images` has its markers
    expanded (and `pixel_values` kept when given); one with `pixel_values`
    but no `images` is admitted unexpanded, so a caller passing
    `pixel_values` must pass `images` too."""
    from qserve_tpu_torch.utils.image_processing import preprocess_images

    j, t = _engines(pair)
    px = preprocess_images([_image(1)], 16)
    for eng, sp in ((j, JSP), (t, TSP)):
        eng.add_request("both", prompt_token_ids=[1, IMG, 2], sampling_params=sp(),
                        multi_modal_data={"images": [None], "pixel_values": px})
        eng.add_request("px", prompt_token_ids=[1, IMG, 2], sampling_params=sp(),
                        multi_modal_data={"pixel_values": px})
        eng.add_request("img", prompt_token_ids=[1, IMG, 2], sampling_params=sp(),
                        multi_modal_data={"images": [_image(1)]})
    lens = {e: {g.request_id: (g.get_seqs()[0].get_len(), g.multi_modal_data)
                for g in e.scheduler.waiting} for e in (j, t)}
    for e in (j, t):
        assert lens[e]["both"][0] == lens[e]["img"][0] == 2 + 4
        assert lens[e]["px"][0] == 3
        assert lens[e]["both"][1]["pixel_values"] is px
        np.testing.assert_array_equal(lens[e]["img"][1]["pixel_values"], px)


# ---------------------------------------------------------------------------
# EngineArgs and the loader
# ---------------------------------------------------------------------------

LLM_CFG = dict(architectures=["LlamaForCausalLM"], vocab_size=256, hidden_size=64,
               intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6)


@pytest.mark.parametrize("preset", ["tiny", "full"])
def test_random_vlm_geometry_is_the_jax_packages(preset, monkeypatch, tmp_path):
    """EngineArgs(run_vlm=True, random_weights=True)'s geometry: a CLIP-L/14-
    336 tower (or the `tiny` preset's) and an mlp_downsample projector over
    the config's LLM, field for field the JAX package's."""
    if preset == "tiny":
        monkeypatch.setenv("QSERVE_TPU_VISION_PRESET", "tiny")
    else:
        monkeypatch.delenv("QSERVE_TPU_VISION_PRESET", raising=False)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(LLM_CFG, f)
    jq, tq = JQ.from_precision("w4a8kv4"), QuantSpec.from_precision("w4a8kv4")
    want = JEngineArgs(model=str(tmp_path), run_vlm=True)._random_vlm_args(jq)
    got = EngineArgs(hf_config=LLM_CFG, run_vlm=True)._random_vlm_args(tq)
    w = vila_args_from_jax(want)
    strip = lambda a: {k: v for k, v in a.__dict__.items() if k != "compute_dtype"}
    assert strip(got.vision) == strip(w.vision) and strip(got.projector) == strip(w.projector)
    assert got.llm == w.llm
    assert got.vision.compute_dtype == got.projector.compute_dtype == torch.bfloat16
    assert w.vision.compute_dtype == w.projector.compute_dtype == torch.bfloat16
    assert got.tokens_per_image == want.tokens_per_image == (4 if preset == "tiny" else 144)
    assert got.llm.hidden_size == 64 and got.projector.llm_hidden == 64


@pytest.mark.parametrize("img_per_seq", [1, 2])
def test_engine_args_build_a_random_vlm(img_per_seq, monkeypatch):
    """run_vlm (and img_per_seq, which the port used to refuse) builds the
    tiny-preset random VLM on the CPU with mixed steps off; it serves an
    image request with img_per_seq images and a text request."""
    monkeypatch.setenv("QSERVE_TPU_VISION_PRESET", "tiny")
    engine = EngineArgs(hf_config=LLM_CFG, random_weights=True, device="cpu", run_vlm=True,
                        img_per_seq=img_per_seq, num_device_pages=32, block_size=16,
                        max_model_len=128, max_num_batched_tokens=64,
                        max_num_seqs=4).build_engine()
    runner = engine.worker.model_runner
    assert runner.vila_args.tokens_per_image == 4
    assert runner.vila_params.vision.layers.qkv_w.dtype == torch.bfloat16
    sc = engine.scheduler.scheduler_config
    assert sc.enable_chunked_prefill and not sc.mixed_chunk_decode
    from PIL import Image

    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 256, (40, 24, 3), np.uint8))
            for _ in range(img_per_seq)]
    out, _ = _serve(engine, [("t", [5, 6, 7], [], _greedy(3))], TSP)
    engine.add_request("i", prompt_token_ids=[1] + [IMG] * img_per_seq + [2, 3],
                       sampling_params=TSP(**_greedy(3)), multi_modal_data={"images": imgs})
    (g,) = engine.scheduler.waiting
    assert g.get_seqs()[0].get_len() == 3 + 4 * img_per_seq
    assert g.multi_modal_data["pixel_values"].shape == (img_per_seq, 3, 32, 32)
    more, _ = _serve(engine, [], TSP)
    assert len(out["t"][0]) == len(more["i"][0]) == 3


def _clip_state(rng, E=32, I=64, L=2, P=8, S=16):
    """An HF CLIPVisionModel state dict (vision_model. prefix)."""
    w = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    st = {"embeddings.patch_embedding.weight": w(E, 3, P, P),
          "embeddings.class_embedding": w(E),
          "embeddings.position_embedding.weight": w((S // P) ** 2 + 1, E),
          "pre_layrnorm.weight": 1 + w(E), "pre_layrnorm.bias": w(E)}
    for li in range(L):
        p = f"encoder.layers.{li}."
        for n in ("q", "k", "v", "out"):
            st[p + f"self_attn.{n}_proj.weight"] = w(E, E)
            st[p + f"self_attn.{n}_proj.bias"] = w(E)
        for n in ("layer_norm1", "layer_norm2"):
            st[p + f"{n}.weight"], st[p + f"{n}.bias"] = 1 + w(E), w(E)
        st[p + "mlp.fc1.weight"], st[p + "mlp.fc1.bias"] = w(I, E), w(I)
        st[p + "mlp.fc2.weight"], st[p + "mlp.fc2.bias"] = w(E, I), w(E)
    return {"vision_model." + k: v for k, v in st.items()}


CLIP_CFG = dict(model_type="clip_vision_model", hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=2, image_size=16, patch_size=8)


def _proj_state(rng, prefix, E_v=32, E=64):
    w = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    return {f"{prefix}0.weight": w(E, E_v), f"{prefix}0.bias": w(E),
            f"{prefix}2.weight": w(E, E), f"{prefix}2.bias": w(E)}


@pytest.fixture(scope="module")
def vlm_dirs(tmp_path_factory):
    """A VILA directory (llm/ with a tokenizer, vision_tower/, mm_projector/)
    and a LLaVA one (one directory; mm_vision_tower names the tower's)."""
    from test_torch_checkpoint import _hf_state, _save_tokenizer, _write_hf

    rng = np.random.default_rng(0)
    llm_state = _hf_state(LLM_CFG, rng)
    vila = tmp_path_factory.mktemp("vila")
    _write_hf(vila / "llm", LLM_CFG, llm_state)
    _save_tokenizer(vila / "llm")
    _write_hf(vila / "vision_tower", CLIP_CFG, _clip_state(rng))
    _write_hf(vila / "mm_projector", {"mm_projector_type": "mlp2x_gelu"},
              _proj_state(rng, "mm_projector.layers."))
    with open(vila / "config.json", "w") as f:
        json.dump({"architectures": ["LlavaLlamaModel"], "mm_projector_type": "mlp2x_gelu"}, f)

    llava = tmp_path_factory.mktemp("llava")
    tower = _write_hf(llava / "tower", {"vision_config": CLIP_CFG}, _clip_state(rng))
    _write_hf(llava / "model", dict(LLM_CFG, mm_vision_tower=tower,
                                    mm_projector_type="mlp2x_gelu"),
              dict(llm_state, **_proj_state(rng, "model.mm_projector.")))
    return str(vila), str(llava / "model")


@pytest.mark.parametrize("layout", ["vila", "llava"])
def test_load_vlm_model_matches_the_jax_loader(vlm_dirs, layout):
    """Both layouts: the LLM quantized bit for bit as the JAX loader's, the
    tower's and projector's weights equal (its matmul weights at the tower's
    compute dtype, bf16), the same geometry."""
    from test_torch_checkpoint import _assert_bit_equal

    model = vlm_dirs[layout == "llava"]
    jargs, jparams = jloader.load_vlm_model(model, JQ.from_precision("w4a8kv4"))
    targs, tparams = tloader.load_vlm_model(model, QuantSpec.from_precision("w4a8kv4"),
                                            device="cpu")
    assert targs.tokens_per_image == jargs.tokens_per_image == 4
    assert targs.projector.kind == jargs.projector.kind == "mlp2x_gelu"
    want = vila_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    _assert_bit_equal(tparams.llm, want.llm)
    bf16 = {"patch_w", "qkv_w", "out_w", "fc1_w", "fc2_w"}
    fields = [(f, getattr(tparams.vision, f), getattr(want.vision, f))
              for f in type(want.vision)._fields if f != "layers"]
    fields += [(f, getattr(tparams.vision.layers, f), getattr(want.vision.layers, f))
               for f in type(want.vision.layers)._fields]
    fields += [("w", g, w.to(torch.bfloat16)) for g, w in
               zip(tparams.projector.weights, want.projector.weights)]
    fields += [("b", g, w) for g, w in zip(tparams.projector.biases, want.projector.biases)]
    for f, g, w in fields:
        assert (g is None) == (w is None), f
        if g is not None:
            assert torch.equal(g, w.to(torch.bfloat16) if f in bf16 else w), f


def test_engine_from_a_vila_directory(vlm_dirs):
    """EngineArgs(model=<VILA dir>, run_vlm=True) reads the tokenizer under
    llm/, tokenizes the <image> tag and serves a text prompt with an image."""
    engine = EngineArgs(model=vlm_dirs[0], run_vlm=True, device="cpu", num_device_pages=32,
                        block_size=16, max_model_len=128, max_num_batched_tokens=64,
                        max_num_seqs=4).build_engine()
    assert engine.tokenizer is not None
    prompt = "<image>\n What is the capital of France ?"
    engine.add_request("i", prompt=prompt, sampling_params=TSP(**_greedy(3)),
                       multi_modal_data={"images": [_image(5)]})
    (g,) = engine.scheduler.waiting
    ids = g.get_seqs()[0].data.prompt_token_ids
    assert ids == tvila.expand_multimodal_prompt(
        tvila.tokenizer_image_token(prompt, engine.tokenizer), 4)
    assert ids.count(IMG) == 4
    out, _ = _serve(engine, [], TSP)
    assert len(out["i"][0]) == 3
