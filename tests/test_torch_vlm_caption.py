"""Port parity of the captioning tools: the webdataset shard reader, the
resumable per-shard captioning loop (`vila_caption.caption_shard` on
both packages' engines with the same weights; `vila_caption.main()` with
DP sharding and a rerun that skips finished shards), `benchmark_image` and
`caption_rewrite` (both packages' entry points on one HF checkpoint), all
on the CPU (`--device cpu`)."""

import io
import json
import os
import sys
import tarfile

os.environ.setdefault("HF_HUB_OFFLINE", "1")  # tokenizers from local directories only

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from qserve_tpu.utils import webdataset as jwds  # noqa: E402
from qserve_tpu_torch.utils import webdataset as twds  # noqa: E402
from test_vlm_caption import make_tar  # noqa: E402


def test_iter_samples_and_first_image(tmp_path):
    p = str(tmp_path / "shard.tar")
    make_tar(p, n=4)
    with tarfile.open(p, "a") as tf:  # a text member and a dir entry too
        data = b"a caption"
        info = tarfile.TarInfo("sample0009.txt")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
        d = tarfile.TarInfo("subdir")
        d.type = tarfile.DIRTYPE
        tf.addfile(d)
    got, want = list(twds.iter_samples(p)), list(jwds.iter_samples(p))
    assert got == want and len(got) == 5
    assert got[2]["json"] == {"idx": 2} and got[4] == {"__key__": "sample0009",
                                                       "txt": "a caption"}
    assert [twds.first_image(s) for s in got] == [jwds.first_image(s) for s in want]
    assert twds.first_image(got[4]) is None


@pytest.mark.parametrize("pattern", ["/x/s-{00003..00005}.tar", "/x/s-{7..12}.tar"])
def test_list_shards_brace(pattern):
    assert twds.list_shards(pattern) == jwds.list_shards(pattern)


def test_list_shards_glob_and_worker_split(tmp_path):
    for i in (2, 0, 1):
        (tmp_path / f"s{i}.tar").write_bytes(b"")
    pattern = str(tmp_path / "s*.tar")
    assert twds.list_shards(pattern) == jwds.list_shards(pattern)
    shards = [f"s{i}" for i in range(10)]
    for w in range(3):
        assert twds.shard_for_worker(shards, w, 3) == jwds.shard_for_worker(shards, w, 3)
    assert sum((twds.shard_for_worker(shards, w, 3) for w in range(3)), []) != shards


class FakeTok:
    """test_vlm_caption.py's fake tokenizer (ids only, no files)."""

    eos_token_id = 0
    bos_token_id = 1

    def encode(self, s):
        return [1] + [ord(c) % 100 + 2 for c in s.strip()][:6]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def test_caption_shard_matches_the_jax_package(tmp_path):
    """Both packages' caption_shard over one 3-sample shard, engines on the
    same tiny VILA weights, batch 2 (a request joins while two decode): the
    same {key: caption} JSON."""
    from qserve_tpu.entrypoints.vila_caption import caption_shard as jcaption
    from qserve_tpu.sampling_params import SamplingParams as JSP
    from qserve_tpu_torch.entrypoints.vila_caption import caption_shard as tcaption
    from qserve_tpu_torch.sampling_params import SamplingParams as TSP
    from test_torch_vlm_engine import _engines

    from qserve_tpu.models import vila as jvila
    from qserve_tpu_torch.convert.from_jax import vila_args_from_jax, vila_params_from_numpy
    from test_vlm_engine import tiny_vila_args

    jargs = tiny_vila_args("w8a8kv8")
    jparams = jvila.random_params(jax.random.PRNGKey(0), jargs)
    both = (jargs, jparams, vila_args_from_jax(jargs),
            vila_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"))
    j, t = _engines(both)
    j.tokenizer = t.tokenizer = FakeTok()
    tar = str(tmp_path / "shard.tar")
    make_tar(tar, n=3)
    sp = dict(max_tokens=3, temperature=0.0, ignore_eos=True)
    want = jcaption(j, tar, str(tmp_path / "j.json"), "<image>\n describe", JSP(**sp), batch=2)
    got = tcaption(t, tar, str(tmp_path / "t.json"), "<image>\n describe", TSP(**sp), batch=2)
    assert len(got) == 3 and got == want
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == got


LLM_CFG = dict(architectures=["LlamaForCausalLM"], vocab_size=256, hidden_size=64,
               intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-6)
SMALL = ["--block-size", "16", "--num-device-pages", "64", "--max-model-len", "128",
         "--max-num-batched-tokens", "256", "--max-num-seqs", "4"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny Llama HF directory with a WordLevel tokenizer."""
    from test_torch_checkpoint import _hf_state, _save_tokenizer, _write_hf

    d = _write_hf(tmp_path_factory.mktemp("cap_hf"), LLM_CFG,
                  _hf_state(LLM_CFG, np.random.default_rng(0)))
    _save_tokenizer(d)
    return d


def _main(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["entry"] + argv)
    main()
    return capsys.readouterr().out


def test_vila_caption_main_resumes_and_shards(hf_dir, tmp_path, monkeypatch, capsys):
    """The port's entry point on the CPU, random tiny-preset VLM over the HF
    directory's config and tokenizer: worker 1 of 2 captions the second of
    two shards only; a rerun skips it; worker 0 then writes the first."""
    from qserve_tpu_torch.entrypoints import vila_caption

    monkeypatch.setenv("QSERVE_TPU_VISION_PRESET", "tiny")
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        make_tar(str(data / f"cc-{i:05d}.tar"), n=2 + i)
    out = tmp_path / "caps"
    argv = ["--model", hf_dir, "--random-weights", "--device", "cpu", "--max-tokens", "3",
            "--data-path", str(data / "cc-{00000..00001}.tar"), "--output-path", str(out),
            "--num-workers", "2"] + SMALL
    printed = _main(vila_caption.main, argv + ["--worker-id", "1"], monkeypatch, capsys)
    assert "cc-00001: 3 captions" in printed and "img/s cumulative" in printed
    assert sorted(os.listdir(out)) == ["cc-00001.json"]
    with open(out / "cc-00001.json") as f:
        caps = json.load(f)
    assert sorted(caps) == [f"sample{i:04d}" for i in range(3)]
    assert all(isinstance(c, str) and c for c in caps.values())
    before = (out / "cc-00001.json").stat().st_mtime_ns
    printed = _main(vila_caption.main, argv + ["--worker-id", "1"], monkeypatch, capsys)
    assert printed.strip() == "skip cc-00001 (exists)"
    assert (out / "cc-00001.json").stat().st_mtime_ns == before
    printed = _main(vila_caption.main, argv + ["--worker-id", "0"], monkeypatch, capsys)
    assert "cc-00000: 2 captions" in printed
    assert sorted(os.listdir(out)) == ["cc-00000.json", "cc-00001.json"]


def test_benchmark_image_main(hf_dir, monkeypatch, capsys):
    """The port's image benchmark on the CPU prints the JAX entry point's
    round line: every request finishes with its generation length."""
    from qserve_tpu_torch.entrypoints import benchmark_image

    monkeypatch.setenv("QSERVE_TPU_VISION_PRESET", "tiny")
    printed = _main(benchmark_image.main,
                    ["--model", hf_dir, "--random-weights", "--device", "cpu",
                     "--global-batch-size", "3", "--generation-len", "4", "--rounds", "2",
                     "--img-per-seq", "2"] + SMALL, monkeypatch, capsys)
    lines = printed.strip().splitlines()
    assert len(lines) == 2
    for r, line in enumerate(lines):
        assert line.startswith(f"round {r}: 3 seqs, 12 tokens, ") and "img-seqs/s" in line


def test_caption_rewrite_matches_the_jax_entry_point(hf_dir, tmp_path, monkeypatch, capsys):
    """Both packages' caption_rewrite over one caption JSON with one HF
    checkpoint (quantized the same at load): the same rewritten JSON; a
    rerun skips the finished shard."""
    from qserve_tpu.entrypoints import caption_rewrite as jrw
    from qserve_tpu_torch.entrypoints import caption_rewrite as trw

    src = tmp_path / "caps"
    src.mkdir()
    with open(src / "cc-00000.json", "w") as f:
        json.dump({"sample0000": "the capital of France", "sample0001": "a thread"}, f)
    common = ["--model", hf_dir, "--input-path", str(src), "--max-tokens", "4"] + SMALL
    _main(jrw.main, common + ["--output-path", str(tmp_path / "j")], monkeypatch, capsys)
    printed = _main(trw.main, common + ["--output-path", str(tmp_path / "t"), "--device", "cpu"],
                    monkeypatch, capsys)
    assert printed.strip() == "cc-00000.json: 2 rewritten"
    with open(tmp_path / "j" / "cc-00000.json") as f:
        want = json.load(f)
    with open(tmp_path / "t" / "cc-00000.json") as f:
        got = json.load(f)
    assert sorted(got) == ["sample0000", "sample0001"] and got == want
    printed = _main(trw.main, common + ["--output-path", str(tmp_path / "t"), "--device", "cpu"],
                    monkeypatch, capsys)
    assert printed.strip() == "skip cc-00000.json (exists)"
