"""The model families (qbench/families/): frozen fingerprints of the two
there are, and a family added by files alone.

The fingerprints were taken from the harness as it stood before the
families were split out of it, and are compared exactly: the float
weights of the tiny cells at seed 5 (a sha256 over every tensor), the
reference's logits over fixed served sequences with chunked prompts at
int8 and at int4 activations, and the operations and least times of fixed
steps (prefill, chunk, mixed and decode, with contexts past the window) at
the tiny and at the real widths. A change that moves any of them changes
what the cells read, and has to say so.
"""

import hashlib
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from qbench import registry
from qbench import run as qrun
from qbench.harness import Step
from qbench.reference.served import Served
from qbench.tests.conftest import tiny_cell
from qbench.weights import WeightMaker

SEED = 5

FROZEN = {
    "mistral": {
        "weights": "2548d74d34eaaf89bd6064aa1d656bd823e510ecf94d629fd774a56c9eb2b39d",
        "logits8": "b193b402b1f88f8c1f2bd3b5621263ed139909bd423def6c74a3a0fb3eb1eb25",
        "logits4": "1a7f05d25573b77a93b234917c108a6e4e2a8436d1f0cde39edbeaae9ef06403",
        "tiny": [[16257536.0, 9.559880597014925e-08, 0.0],
                 [11419648.0, 6.766805970149254e-08, 0.0],
                 [6735872.0, 4.384477611940298e-08, 1.4347462686567164e-08],
                 [1154560.0, 1.7557014925373133e-08, 1.7607164179104478e-08],
                 [3765760.0, 2.6593432835820895e-08, 7.825671641791045e-08],
                 [0.0, 0.0, 0.0]],
        "real": [[29193156952064.0, 0.014445327095591712, 0.0],
                 [32983220224000.0, 0.014445327095591712, 0.0],
                 [30505166700544.0, 0.013838736211694794, 0.00045394741492537315],
                 [2026572349440.0, 0.001182738951641791, 0.005394142299701492],
                 [65472561152.0, 0.0010492814901492536, 0.0002219868847761194]],
    },
    "mixtral": {
        "weights": "8b7e5fe62f9bfd1a9e906cbd73f56012942d1126db8a4e5527b1a8db60a3b690",
        "logits8": "7a111cb8d050849b4bd42086f3e9da40f5e64b91a04d4d454796db441e2187ae",
        "logits4": "033091110204bd76970406df75e6049d92e106c01e5863c8b30738b8c2f45f21",
        "tiny": [[26319872.0, 1.7281910447761193e-07, 0.0],
                 [19648000.0, 1.27675223880597e-07, 0.0],
                 [12070400.0, 8.917014925347335e-08, 1.4347462686567164e-08],
                 [1783808.0, 4.557373134328358e-08, 1.7607164179104478e-08],
                 [6000640.0, 6.128662313432835e-08, 7.825671641791045e-08],
                 [0.0, 0.0, 0.0]],
        "real": [[52287196102656.0, 0.0261127066728004, 0.0],
                 [57076619411456.0, 0.0261127066728004, 0.0],
                 [52632123080704.0, 0.02501617699806367, 0.00045394741492537315],
                 [3534556758016.0, 0.007192507529552238, 0.005394142299701492],
                 [113149739008.0, 0.004823529685970149, 0.0002219868847761194]],
    },
}
REAL = {"mistral": "mistral-7b-v0.1.w4a8kv4", "mixtral": "mixtral-8x7b-v0.1.w4a8kv4"}


def _step(kind, spans=(), ctx=(), rows=0):
    return Step(0.0, 1.0, kind, 0, list(ctx), list(spans), rows, 0, 0)


# the tiny dense cell's window is 48 tokens, the real Mistral's 4096
TINY_STEPS = [_step("prefill", [(0, 30), (0, 70)], rows=2), _step("chunk", [(64, 130)], rows=1),
              _step("mixed", [(128, 160)], [5, 47, 48, 49, 200], rows=6),
              _step("decode", ctx=[1, 30, 48, 100, 255], rows=5),
              _step("decode", ctx=list(range(10, 250, 15)), rows=16), _step("decode")]
REAL_STEPS = [_step("prefill", [(0, 700), (0, 1348)], rows=2),
              _step("chunk", [(4000, 6048)], rows=1),
              _step("mixed", [(2048, 4000)], list(range(3000, 6000, 300)), rows=11),
              _step("decode", ctx=list(range(100, 8000, 62)), rows=128),
              _step("decode", ctx=[4095, 4096, 4097, 9000], rows=4)]


def _tiny(name):
    cfg = tiny_cell(name == "mixtral").config
    return cfg, registry.family_of(cfg)


def _maker(cfg, family):
    return WeightMaker(SEED, cfg, "cpu", family.sizes(cfg))


def _digest(h, name, x):
    x = x.detach().contiguous().cpu()
    h.update(f"{name}|{x.dtype}|{tuple(x.shape)}|".encode())
    h.update(x.view(torch.uint8).numpy().tobytes() if x.dtype == torch.bfloat16
             else x.numpy().tobytes())


def _served(vocab):
    rng = np.random.default_rng(20261018)
    return [Served(prompt=rng.integers(3, vocab, n).astype(np.int64),
                   tokens=rng.integers(3, vocab, t).astype(np.int64),
                   chunk_ends=list(ends), scored=scored)
            for n, ends, t, scored in ((70, [32, 64, 70], 24, 24), (20, [20], 10, 6),
                                       (40, [16, 40], 60, 30))]


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_float_weights_are_frozen(name):
    cfg, family = _tiny(name)
    p = family.float_params(_maker(cfg, family))
    h = hashlib.sha256()
    for k in ("embed", "final_ln", "lm_head"):
        _digest(h, k, p[k])
    for li, layer in enumerate(p["layers"]):
        for key in layer:
            v = layer[key]
            if isinstance(v, torch.Tensor):
                _digest(h, f"{li}.{key}", v)
            else:
                for e in range(len(v)):
                    _digest(h, f"{li}.{key}.{e}", v[e])
    assert h.hexdigest() == FROZEN[name]["weights"]


@pytest.mark.parametrize("act_bits", [8, 4])
@pytest.mark.parametrize("name", sorted(FROZEN))
def test_reference_logits_are_frozen(name, act_bits):
    cfg, family = _tiny(name)
    ref = family.Reference(_maker(cfg, family), act_bits=None if act_bits == 8 else act_bits)
    h = hashlib.sha256()
    for x in ref.served_logits(_served(cfg["vocab_size"])):
        _digest(h, "logits", x)
    assert h.hexdigest() == FROZEN[name][f"logits{act_bits}"]


@pytest.mark.parametrize("widths", ["tiny", "real"])
@pytest.mark.parametrize("name", sorted(FROZEN))
def test_op_and_byte_counts_are_frozen(name, widths):
    if widths == "tiny":
        cfg, family = _tiny(name)
        steps = TINY_STEPS
    else:
        cfg = registry.load_config(REAL[name])
        family, steps = registry.family_of(cfg), REAL_STEPS
    sz = family.sizes(cfg)
    got = [[family.step_ops(s, sz), family.gemm_bound_s(s, sz), family.paged_attn_bound_s(s, sz)]
           for s in steps]
    assert got == FROZEN[name][widths]


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_family_added_by_files_alone_serves_correctly(tmp_path):
    """A copy of the benchmark gains a configuration whose model_type is a
    new name, that family's module (a copy of the dense family), a cell, a
    traffic mix and a limits file, and edits no file already there; the
    cell then runs correct on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.QBENCH, root / "qbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), root)
    before = _tree(root / "qbench")
    q = root / "qbench"
    tiny = tiny_cell(False)
    cfg = dict(tiny.config, model_type="dense_copy")
    json.dump(cfg, open(q / "configs" / "dense-copy.tiny.json", "w"))
    shutil.copy(q / "families" / "mistral.py", q / "families" / "dense_copy.py")
    json.dump(tiny.traffic, open(q / "traffic" / "decode-batch-tiny.json", "w"))
    json.dump({"logit_gap": {"limit": 1.0}, "mean_gap": {"limit": 0.05}},
              open(q / "limits" / "dense-copy.decode-batch-tiny.json", "w"))
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "dense-copy.tiny", "source": "x", "reduced": [],
                             "file": "qbench/configs/dense-copy.tiny.json", "why": "a new family"})
    bench["workloads"].append({"name": "dense-copy.decode-batch-tiny", "config": "dense-copy.tiny",
                               "traffic": "decode-batch-tiny", "chips": 1, "why": "files alone"})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    after = _tree(root / "qbench")
    assert all(after[k] == v for k, v in before.items())  # nothing already there changed

    cell = registry.load_cell("dense-copy.decode-batch-tiny", root=str(root))
    assert cell.family.__file__ == str(q / "families" / "dense_copy.py")
    out = qrun.run_cell(cell, SEED, 1.5, False, "cpu", time.perf_counter(), num_pages=128)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"output_tok_s", "setup_s"}
    assert out["checks"]["mean_gap"]["tokens"] > 0
