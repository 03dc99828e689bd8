"""Port parity of the VLM modules: the vision tower (CLIP and SigLIP
branches), its HF state loading, the projector (linear, mlp2x_gelu,
mlp_downsample at an even and an odd grid), prompt expansion and
`tokenizer_image_token`, `preprocess_images`, `encode_images`, and the
image-spliced `vlm_prefill` / `vlm_prefill_chunk` (logits and KV bytes).
The same numpy inputs and weights (the JAX package's, moved across by
convert/from_jax.py) go through both packages.

Tolerances: the tower at f32 within 1e-5 of the largest |feature| (the two
sides sum f32 products in other orders); at bf16 each element within one
bf16 step plus 1e-2 of the largest |feature| (a bf16 rounding that lands a
neighbour apart propagates through the layers; the measured need is
printed). The projector at f32 within 1e-5 of the largest output. The
LLM's logits within test_torch_llama's ATOL (1e-2)."""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu.models import clip as jclip
from qserve_tpu.models import mm_projector as jproj
from qserve_tpu.models import vila as jvila
from qserve_tpu.utils import image_processing as jimg
from qserve_tpu_torch import native
from qserve_tpu_torch.convert.from_jax import (
    tensor_from_numpy, torch_dtype, vila_args_from_jax, vila_params_from_numpy)
from qserve_tpu_torch.kernels import kv_cache as tkvc
from qserve_tpu_torch.models import clip as tclip
from qserve_tpu_torch.models import mm_projector as tproj
from qserve_tpu_torch.models import vila as tvila
from qserve_tpu_torch.utils import image_processing as timg
from qserve_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX as IMG
from test_torch_llama import ATOL, _assert_bytes_follow_kv, appended  # noqa: F401
from torch_port_util import TINY, tiny_pair, to_np

# the `tiny` preset's tower (64 wide, image 32, patch 8) at 3 layers, so
# feature_layer -2 runs two
TOWER = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
             num_attention_heads=4, image_size=32, patch_size=8)
KINDS = {"clip": "clip_vision_model", "siglip": "siglip_vision_model"}


def _tower(kind, jdtype, seed=0):
    """(JAX args, JAX params, port args, port params) of one tiny tower
    with the JAX package's random weights at scale 0.1."""
    cfg = dict(TOWER, model_type=KINDS[kind])
    jargs = jclip.VisionArgs(**{**jclip.VisionArgs.from_hf_config(cfg).__dict__,
                                "compute_dtype": jdtype})
    targs = tclip.VisionArgs(**{**tclip.VisionArgs.from_hf_config(cfg).__dict__,
                                "compute_dtype": torch_dtype(jdtype)})
    jparams = jclip.random_params(jax.random.PRNGKey(seed), jargs, scale=0.1)
    n = jax.tree.map(np.asarray, jparams)
    t = lambda x: None if x is None else tensor_from_numpy(x, "cpu")
    tparams = tclip.VisionParams(
        t(n.patch_w), t(n.patch_b), t(n.class_embed), t(n.pos_embed), t(n.pre_ln_scale),
        t(n.pre_ln_bias), tclip.VisionLayerParams(*(t(x) for x in n.layers)))
    return jargs, jparams, targs, tparams


def _images(n, size=32, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("kind", ["clip", "siglip"])
def test_vision_args_from_hf_config(kind):
    cfg = dict(TOWER, model_type=KINDS[kind])
    j = jclip.VisionArgs.from_hf_config(cfg).__dict__
    t = tclip.VisionArgs.from_hf_config(cfg).__dict__
    assert {k: v for k, v in t.items() if k != "compute_dtype"} == \
        {k: v for k, v in j.items() if k != "compute_dtype"}
    assert t["compute_dtype"] == torch.bfloat16
    siglip = kind == "siglip"
    assert t["use_class_token"] != siglip and t["use_pre_layernorm"] != siglip
    assert t["layer_norm_eps"] == (1e-6 if siglip else 1e-5)
    assert t["hidden_act"] == ("gelu_pytanh" if siglip else "quick_gelu")


@pytest.mark.parametrize("kind", ["clip", "siglip"])
def test_tower_f32(kind):
    jargs, jparams, targs, tparams = _tower(kind, jnp.float32)
    img = _images(2)
    want = np.asarray(jclip.forward_features(jparams, jnp.asarray(img), jargs))
    got = tclip.forward_features(tparams, torch.from_numpy(img), targs)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 16, 64)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    print(f"{kind} f32: max |diff| / max |feature| = {rel:.3g}")
    assert rel <= 1e-5


@pytest.mark.parametrize("kind", ["clip", "siglip"])
def test_tower_bf16(kind):
    jargs, jparams, targs, tparams = _tower(kind, jnp.bfloat16)
    img = _images(2, seed=2)
    want = np.asarray(jclip.forward_features(jparams, jnp.asarray(img), jargs), np.float32)
    got = tclip.forward_features(tparams, torch.from_numpy(img), targs)
    assert got.dtype == torch.bfloat16
    diff, peak = np.abs(to_np(got) - want), np.abs(want).max()
    need = ((diff - 2.0**-7 * np.abs(want)) / peak).max()
    print(f"{kind} bf16: max |diff| {diff.max():.3g} of max |feature| {peak:.3g}; "
          f"the floor that would just pass: {need:.3g} (limit 1e-2)")
    assert (diff <= 2.0**-7 * np.abs(want) + 1e-2 * peak).all()


def _hf_tower_state(kind, prefix, spelling, rng):
    """A HF vision-tower state dict ([out, in] weights) at TOWER's widths."""
    E, I, P = TOWER["hidden_size"], TOWER["intermediate_size"], TOWER["patch_size"]
    siglip = kind == "siglip"
    n_pos = (TOWER["image_size"] // P) ** 2 + (0 if siglip else 1)
    w = lambda *s: rng.standard_normal(s).astype(np.float32)
    st = {"embeddings.patch_embedding.weight": w(E, 3, P, P),
          "embeddings.position_embedding.weight": w(n_pos, E)}
    if siglip:
        st["embeddings.patch_embedding.bias"] = w(E)
        st["post_layernorm.weight"] = w(E)  # read by neither package
    else:
        st["embeddings.class_embedding"] = w(E)
        st[f"{spelling}.weight"], st[f"{spelling}.bias"] = w(E), w(E)
    for li in range(TOWER["num_hidden_layers"]):
        p = f"encoder.layers.{li}."
        for n in ("q", "k", "v", "out"):
            st[p + f"self_attn.{n}_proj.weight"] = w(E, E)
            st[p + f"self_attn.{n}_proj.bias"] = w(E)
        for n in ("layer_norm1", "layer_norm2"):
            st[p + f"{n}.weight"], st[p + f"{n}.bias"] = w(E), w(E)
        st[p + "mlp.fc1.weight"], st[p + "mlp.fc1.bias"] = w(I, E), w(I)
        st[p + "mlp.fc2.weight"], st[p + "mlp.fc2.bias"] = w(E, I), w(E)
    return {prefix + k: v for k, v in st.items()}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind,prefix,spelling", [
    ("clip", "", "pre_layrnorm"),
    ("clip", "vision_model.", "pre_layrnorm"),
    ("clip", "vision_tower.vision_model.", "pre_layernorm"),
    ("siglip", "vision_model.", None),
    ("siglip", "vision_tower.vision_model.", None),
])
def test_tower_params_from_hf_state(kind, prefix, spelling, dtype):
    """Equal to the JAX package's params: matmul weights in the compute
    dtype (the JAX package's cast at f32 equals them at bf16), the rest
    f32; the HF state as numpy arrays or as torch tensors."""
    cfg = dict(TOWER, model_type=KINDS[kind])
    jargs = jclip.VisionArgs.from_hf_config(cfg)
    targs = tclip.VisionArgs(**{**tclip.VisionArgs.from_hf_config(cfg).__dict__,
                                "compute_dtype": torch_dtype(dtype)})
    state = _hf_tower_state(kind, prefix, spelling, np.random.default_rng(4))
    want = jclip.params_from_hf_state(state, jargs)
    for st in (state, {k: torch.from_numpy(v) for k, v in state.items()}):
        got = tclip.params_from_hf_state(st, targs, device="cpu")
        pairs = [(getattr(got, f), getattr(want, f)) for f in tclip.VisionParams._fields
                 if f != "layers"]
        pairs += [(getattr(got.layers, f), getattr(want.layers, f))
                  for f in tclip.VisionLayerParams._fields]
        weights = {id(got.patch_w)} | {id(getattr(got.layers, f))
                                       for f in ("qkv_w", "out_w", "fc1_w", "fc2_w")}
        for g, w in pairs:
            assert (g is None) == (w is None)
            if g is None:
                continue
            wd = dtype if id(g) in weights else jnp.float32
            assert g.dtype == torch_dtype(wd)
            np.testing.assert_array_equal(to_np(g), np.asarray(jnp.asarray(w).astype(wd),
                                                               np.float32))


@pytest.mark.parametrize("kind,grid,vis,llm", [
    ("linear", 4, 64, 96), ("mlp2x_gelu", 4, 64, 96),
    ("mlp_downsample", 4, 16, 32), ("mlp_downsample", 3, 16, 32),
])
def test_projector(kind, grid, vis, llm):
    jargs = jproj.ProjectorArgs(kind, vis, llm, grid=grid, compute_dtype=jnp.float32)
    targs = tproj.ProjectorArgs(kind, vis, llm, grid=grid, compute_dtype=torch.float32)
    assert targs.tokens_per_image == jargs.tokens_per_image
    assert targs.in_features == jargs.in_features
    jp = jproj.random_params(jax.random.PRNGKey(2), jargs, scale=0.3)
    tp = tproj.ProjectorParams(
        tuple(tensor_from_numpy(np.asarray(w), "cpu") for w in jp.weights),
        tuple(tensor_from_numpy(np.asarray(b), "cpu") for b in jp.biases))
    x = np.random.default_rng(3).standard_normal((2, grid * grid, vis)).astype(np.float32)
    want = np.asarray(jproj.apply_projector(jp, jnp.asarray(x), jargs))
    got = tproj.apply_projector(tp, torch.from_numpy(x), targs).numpy()
    assert got.shape == want.shape == (2, jargs.tokens_per_image, llm)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("grid", [4, 3, 27])
def test_downsample_2x2_layout(grid):
    """Data movement only: equal to the JAX package's; an odd grid pads the
    bottom and right edges (SigLIP-384's 27 becomes 14 x 14 = 196)."""
    x = np.arange(2 * grid * grid * 3, dtype=np.float32).reshape(2, grid * grid, 3)
    want = np.asarray(jproj.downsample_2x2(jnp.asarray(x), grid))
    got = tproj.downsample_2x2(torch.from_numpy(x), grid).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == (-(-grid // 2)) ** 2
    if grid == 4:
        np.testing.assert_array_equal(got[0, 0, ::3] / 3, [0, 1, 4, 5])  # (r, c) (r, c+1) (r+1, c) (r+1, c+1)


@pytest.mark.parametrize("keys", ["model.mm_projector.{i}", "mm_projector.{i}",
                                  "model.mm_projector.layers.{i}", "bare"])
def test_projector_params_from_hf_state(keys):
    rng = np.random.default_rng(5)
    if keys == "bare":
        state = {"model.mm_projector.weight": rng.standard_normal((12, 8), np.float32),
                 "model.mm_projector.bias": rng.standard_normal(12, np.float32)}
        kind = "linear"
    else:
        state = {}
        for i, (o, n) in ((0, (12, 8)), (2, (12, 12))):
            state[keys.format(i=i) + ".weight"] = rng.standard_normal((o, n), np.float32)
            state[keys.format(i=i) + ".bias"] = rng.standard_normal(o, np.float32)
        kind = "mlp2x_gelu"
    want = jproj.params_from_hf_state(state, jproj.ProjectorArgs(kind, 8, 12, grid=2))
    for dt in (torch.float32, torch.bfloat16):
        got = tproj.params_from_hf_state(
            state, tproj.ProjectorArgs(kind, 8, 12, grid=2, compute_dtype=dt), device="cpu")
        assert len(got.weights) == len(want.weights)
        for g, w in zip(got.weights, want.weights):
            assert g.dtype == dt
            np.testing.assert_array_equal(to_np(g), to_np(torch.from_numpy(np.array(w)).to(dt)))
        for g, w in zip(got.biases, want.biases):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_projector_refuses_a_layernorm():
    """VILA's mlp_downsample keeps LayerNorm(4 * D) at layers.1; neither
    package serves it, and the port's loader says so instead of reading the
    1-D weight as a linear."""
    rng = np.random.default_rng(6)
    state = {"model.mm_projector.layers.1.weight": np.ones(32, np.float32),
             "model.mm_projector.layers.1.bias": np.zeros(32, np.float32)}
    for i, (o, n) in ((2, (12, 32)), (4, (12, 12))):
        state[f"model.mm_projector.layers.{i}.weight"] = rng.standard_normal((o, n), np.float32)
        state[f"model.mm_projector.layers.{i}.bias"] = rng.standard_normal(o, np.float32)
    with pytest.raises(NotImplementedError, match="LayerNorm"):
        tproj.params_from_hf_state(state, tproj.ProjectorArgs("mlp_downsample", 8, 12, grid=2),
                                   device="cpu")


def test_expand_multimodal_prompt():
    ids = [1, 2, IMG, 3, IMG, IMG]
    assert tvila.expand_multimodal_prompt(ids, 4) == jvila.expand_multimodal_prompt(ids, 4)
    assert tvila.expand_multimodal_prompt(ids, 4) == [1, 2] + [IMG] * 4 + [3] + [IMG] * 8


@pytest.fixture(scope="module")
def bos_tokenizer(tmp_path_factory):
    """A WordLevel tokenizer whose encode() prepends BOS, built in tmp_path."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    words = ["<unk>", "<s>", "</s>", "describe", "the", "image", "and", "compare", "it",
             "with", ".", "\n", "?", ":", "USER", "ASSISTANT"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    d = tmp_path_factory.mktemp("bos_tok")
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(str(d))
    from qserve_tpu_torch.utils.tokenizer import get_tokenizer

    return get_tokenizer(str(d))


@pytest.mark.parametrize("prompt", [
    "USER: <image>\n describe the image . ASSISTANT:",
    "<image> compare it with <image> ?",
    "describe the image",
])
def test_tokenizer_image_token(bos_tokenizer, prompt):
    got = tvila.tokenizer_image_token(prompt, bos_tokenizer)
    assert got == jvila.tokenizer_image_token(prompt, bos_tokenizer)
    assert got[0] == 1 and got.count(1) == 1  # one BOS: the later chunks' went
    assert got.count(IMG) == prompt.count("<image>")


def _pil(seed, w, h):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("mean_std", ["clip", "siglip"])
def test_preprocess_images_bit_for_bit(mean_std):
    """Non-square images (padded to a square), a PNG's bytes and a base64
    data URL, at both normalisations: equal to the JAX package's bits."""
    ms = dict(clip=(timg.CLIP_MEAN, timg.CLIP_STD),
              siglip=(timg.SIGLIP_MEAN, timg.SIGLIP_STD))[mean_std]
    assert ms == dict(clip=(jimg.CLIP_MEAN, jimg.CLIP_STD),
                      siglip=(jimg.SIGLIP_MEAN, jimg.SIGLIP_STD))[mean_std]
    buf = io.BytesIO()
    _pil(3, 17, 17).save(buf, format="PNG")
    url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    imgs = [_pil(1, 20, 12), _pil(2, 9, 31), buf.getvalue(), url]
    for pad in (True, False):
        want = jimg.preprocess_images(imgs, 32, *ms, pad_to_square=pad)
        got = timg.preprocess_images(imgs, 32, *ms, pad_to_square=pad)
        assert got.dtype == np.float32 and got.shape == (4, 3, 32, 32)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def llm_pair():
    return tiny_pair()


@pytest.fixture(scope="module")
def tiny_vila(llm_pair):
    """A tiny VILA on both sides with the same weights: an f32 tower
    (tests/test_vlm_engine.py's: 32 wide, 2 layers, image 16, patch 8) and
    an mlp2x_gelu projector (4 tokens an image) over the tiny W4A8KV4 LLM."""
    jl_args, jl_params, _, _ = llm_pair
    vargs = jclip.VisionArgs(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                             image_size=16, patch_size=8, compute_dtype=jnp.float32)
    pargs = jproj.ProjectorArgs("mlp2x_gelu", 32, TINY["hidden_size"], grid=vargs.grid,
                                compute_dtype=jnp.float32)
    jargs = jvila.VilaArgs(llm=jl_args, vision=vargs, projector=pargs)
    kv, kp = jax.random.split(jax.random.PRNGKey(0))
    jparams = jvila.VilaParams(vision=jclip.random_params(kv, vargs),
                               projector=jproj.random_params(kp, pargs), llm=jl_params)
    targs = vila_args_from_jax(jargs)
    tparams = vila_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jargs, jparams, targs, tparams


def test_vila_args_and_params_cross(tiny_vila):
    jargs, jparams, targs, tparams = tiny_vila
    assert targs.tokens_per_image == jargs.tokens_per_image == 4
    assert targs.vision.compute_dtype == targs.projector.compute_dtype == torch.float32
    assert (targs.llm.quant.weight_bits, targs.llm.quant.kv_bits) == (4, 4)
    assert (targs.llm.hidden_size, targs.llm.num_layers) == (TINY["hidden_size"], 2)
    assert tparams.vision.layers.qkv_w.dtype == torch.float32
    np.testing.assert_array_equal(tparams.vision.layers.fc2_w.numpy(),
                                  np.asarray(jparams.vision.layers.fc2_w))


def test_encode_images(tiny_vila):
    jargs, jparams, targs, tparams = tiny_vila
    img = _images(3, size=16)
    want = np.asarray(jvila.encode_images(jparams, jnp.asarray(img), jargs))
    got = tvila.encode_images(tparams, torch.from_numpy(img), targs).numpy()
    assert got.shape == want.shape == (3 * 4, TINY["hidden_size"])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_random_vila_params(tiny_vila):
    """The port's random VLM: the tower's matmul weights in bf16, the rest
    f32, the LLM equal to a text model's of the same seed."""
    from qserve_tpu_torch.models import llama as tllama

    _, _, args, _ = tiny_vila
    args = tvila.VilaArgs(
        llm=args.llm, vision=tclip.VisionArgs(**{**args.vision.__dict__,
                                                "compute_dtype": torch.bfloat16}),
        projector=args.projector)
    p = tvila.random_params(3, args, device="cpu")
    assert p.vision.layers.qkv_w.dtype == torch.bfloat16
    assert p.vision.pos_embed.dtype == p.vision.layers.qkv_b.dtype == torch.float32
    assert p.vision.class_embed is not None and p.vision.patch_b is None
    llm = tllama.random_quantized_params(3, args.llm, device="cpu")
    assert torch.equal(p.llm.layers.qkv.qweight, llm.layers.qkv.qweight)
    img = torch.from_numpy(_images(2, size=16))
    emb = tvila.encode_images(p, img, args)
    assert emb.shape == (8, TINY["hidden_size"]) and torch.isfinite(emb).all()


# ---------------------------------------------------------------------------
# image-spliced prefill and chunk (the tiny W4A8KV4 LLM of torch_port_util)
# ---------------------------------------------------------------------------

PS = 16


def _embeds(n_rows, seed=6):
    return (np.random.default_rng(seed).standard_normal((n_rows, TINY["hidden_size"]))
            * 0.05).astype(np.float32)


def _run_both(llm_pair, fn_t, fn_j, inp, embeds, extra_t=(), extra_j=(), caches=None):
    jargs, jparams, targs, tparams = llm_pair
    tkv, jkv = caches
    tl, tkv = fn_t(tparams, tkv, torch.from_numpy(inp[0]), torch.from_numpy(embeds),
                   *map(torch.from_numpy, inp[1:]), *extra_t, targs)
    jl, jkv2 = fn_j(jparams, jkv, jnp.asarray(inp[0]), jnp.asarray(embeds),
                    *map(jnp.asarray, inp[1:]), *extra_j, jargs)
    return tl, jl, tkv, jkv2


def _caches(targs):
    a = (targs.num_layers, 12, targs.num_kv_heads, PS, targs.head_dim)
    return tkvc.create_kv_cache(*a, device="cpu"), jkvc.create_kv_cache(*a)


def test_vlm_prefill_logits_and_cache(llm_pair, appended):
    """Two prompts with three images (the second prompt starts on a marker
    run) packed with a pad tail: logits within ATOL; the cache append is
    byte-exact on the same K/V and rows differ only where the models' bf16
    K/V differ, which they do on a few rows by at most one bf16 step of the
    largest |K/V| (a neighbour flip, test_torch_llama's docstring)."""
    jargs, jparams, targs, tparams = llm_pair
    tpi = 4
    r = np.random.default_rng(7)
    t = lambda n: r.integers(1, TINY["vocab_size"], n).tolist()
    prompts = [t(3) + [IMG] * tpi + t(5) + [IMG] * tpi + t(2), [IMG] * tpi + t(9)]
    tok, pos, seg, pg, sl, ii, li, _ = native.pack_prefill(
        prompts, [[0, 1], [2, 3]], PS, 48, 2, image_token=IMG)
    assert ii[tok == IMG].tolist() == list(range(3 * tpi))
    tkv, jkv = _caches(targs)
    inp = (tok, ii, pos, seg, pg, sl, li)
    tl, jl, tkv, jkv2 = _run_both(llm_pair, tvila.vlm_prefill, jvila.vlm_prefill, inp,
                                  _embeds(3 * tpi), caches=(tkv, jkv))
    assert tl.shape == (2, TINY["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    n_differ = _assert_bytes_follow_kv(tkv, jkv2, jkv, appended, 0, pg, sl)
    (tk, tv), (jk, jv) = appended["t"][0], appended["j"][0]
    rel = max(np.abs(to_np(t) - np.asarray(j, np.float32)).max() / np.abs(to_np(t)).max()
              for t, j in ((tk, jk), (tv, jv)))
    print(f"vlm_prefill: {n_differ} of {2 * (seg > 0).sum()} K/V rows differ, "
          f"by up to {rel:.3g} of max |K/V|")
    assert rel <= 2.0**-7
    # the images matter: other embeddings, other logits
    tl2, _ = tvila.vlm_prefill(tparams, _caches(targs)[0], torch.from_numpy(tok),
                               torch.from_numpy(_embeds(3 * tpi, seed=8)),
                               *map(torch.from_numpy, (ii, pos, seg, pg, sl, li)), targs)
    assert (tl2 - tl).abs().max() > 1e-3


def test_vlm_prefill_chunk_straddling_markers(llm_pair, appended):
    """A 44-token prompt whose second image's markers straddle position 32:
    its first 32 tokens by vlm_prefill, then tokens 32..43 as a chunk over
    that prefix whose marker rows are shifted by the markers before it
    (img_before), as the runner does. Logits of both steps within ATOL; the
    chunk's cache rows byte-exact on the same K/V, none differing here."""
    jargs, jparams, targs, tparams = llm_pair
    tpi = 8
    r = np.random.default_rng(9)
    t = lambda n: r.integers(1, TINY["vocab_size"], n).tolist()
    ids = t(10) + [IMG] * tpi + t(10) + [IMG] * tpi + t(8)
    assert ids[28:36].count(IMG) == tpi and ids[31] == ids[32] == IMG
    embeds = _embeds(2 * tpi, seed=10)
    table = [4, 5, 6]
    tkv, jkv = _caches(targs)
    tok, pos, seg, pg, sl, ii, li, _ = native.pack_prefill([ids[:32]], [table], PS, 32, 1,
                                                           image_token=IMG)
    tl, jl, tkv, jkv = _run_both(llm_pair, tvila.vlm_prefill, jvila.vlm_prefill,
                                 (tok, ii, pos, seg, pg, sl, li), embeds, caches=(tkv, jkv))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    tok, pos, seg, pg, sl, ii, li, _ = native.pack_prefill(
        [ids[32:]], [table], PS, 16, 1, starts=[32], image_token=IMG)
    before = ids[:32].count(IMG)
    ii = np.where(tok == IMG, ii + before, 0).astype(np.int32)
    assert ii[:4].tolist() == [12, 13, 14, 15]  # the straddling image's last rows
    bt = np.array([table], np.int32)
    tl, jl, tkv, jkv2 = _run_both(
        llm_pair, tvila.vlm_prefill_chunk, jvila.vlm_prefill_chunk,
        (tok, ii, pos, seg, pg, sl, li), embeds,
        extra_t=(torch.from_numpy(bt), 32), extra_j=(jnp.asarray(bt), jnp.int32(32)),
        caches=(tkv, jkv))
    assert tl.shape == (1, TINY["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    n_differ = _assert_bytes_follow_kv(tkv, jkv2, jkv, appended, 1, pg, sl)
    print(f"vlm_prefill_chunk: {n_differ} K/V rows differ")
    assert n_differ == 0


def test_vlm_prefill_without_images_is_prefill(llm_pair):
    """No marker: the splice is the token embedding, and the logits equal
    the plain prefill's bit for bit."""
    from qserve_tpu_torch.models import llama as tllama

    jargs, jparams, targs, tparams = llm_pair
    ids = np.random.default_rng(11).integers(1, TINY["vocab_size"], 20).tolist()
    tok, pos, seg, pg, sl, ii, li, _ = native.pack_prefill([ids], [[0, 1]], PS, 32, 1,
                                                           image_token=IMG)
    a, _ = tvila.vlm_prefill(tparams, _caches(targs)[0], torch.from_numpy(tok),
                             torch.zeros(1, TINY["hidden_size"]),
                             *map(torch.from_numpy, (ii, pos, seg, pg, sl, li)), targs)
    b, _ = tllama.prefill(tparams, _caches(targs)[0],
                          *map(torch.from_numpy, (tok, pos, seg, pg, sl, li)), targs)
    assert torch.equal(a, b)
