"""The port's native batch marshal (qserve_tpu_torch/native: marshal.cpp
built by g++, called through ctypes) bit for bit against its numpy versions
and against the JAX package's qserve_tpu.native, on the cases of
tests/test_native_marshal.py, image indices, chunk starts and seeded random
batches; plus the build: concurrent first builds, the switch, and a failed
build raising."""

import os
import subprocess
import sys

import numpy as np
import pytest

from qserve_tpu import native as jnative
from qserve_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def lib():
    assert native.get_lib() is not None
    return native.get_lib()


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype == np.int32 and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert int(x) == int(y)


DECODE_CASES = [
    ([5, 6, 7], [10, 200, 33], [[1, 2], [3, 4, 5, 6], [7]], 4, 5),
    ([9], [3], [[2, 8]], 4, 3),
    ([1, 2], [5, 6], [[1, 2, 3, 4, 5, 6], [7]], 2, 3),  # a table past maxP
    ([], [], [], 4, 2),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=range(len(DECODE_CASES)))
def test_pack_decode_matches_plain_and_jax(case):
    got = native.pack_decode(*case)
    _same(got, native.pack_decode_plain(*case))
    _same(got, jnative.pack_decode(*case))


def test_pack_decode_padding():
    tok, ctx, bt = native.pack_decode([9], [3], [[2, 8]], B_pad=4, maxP=3)
    assert tok.tolist() == [9, 0, 0, 0]
    assert ctx.tolist() == [3, 0, 0, 0]
    assert bt.tolist() == [[2, 8, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]]


PREFILL_CASES = [
    (([[11, 12, 13, -200, -200, 14], [21, 22]], [[0, 1, 2], [3]], 2, 16, 4),
     dict(image_token=-200)),
    (([[11, 12, 13], [21, 22]], [[4, 5], [6]], 2, 8, 2), {}),
    (([[1, -200, -200, 2], [-200, 3]], [[0], [1]], 8, 8, 2), dict(image_token=-200)),
    # chunks: starts past 0, over the pages of their prefix
    (([[5, 6, 7], [8]], [[0, 1, 2], [3, 4]], 4, 8, 2), dict(starts=[6, 4])),
    (([[5, -200, 7]], [[9, 10, 11]], 4, 4, 1), dict(starts=[9], image_token=-200)),
    (([[], [3, 4]], [[], [2]], 4, 4, 4), {}),  # an empty prompt
]


@pytest.mark.parametrize("case", PREFILL_CASES, ids=range(len(PREFILL_CASES)))
def test_pack_prefill_matches_plain_and_jax(case):
    args, kw = case
    got = native.pack_prefill(*args, **kw)
    _same(got, native.pack_prefill_plain(*args, **kw))
    _same(got, jnative.pack_prefill(*args, **kw))


def test_pack_prefill_layout():
    tok, pos, seg, pg, sl, img, last, total = native.pack_prefill(
        [[11, 12, 13], [21, 22]], [[4, 5], [6]], block_size=2, T_pad=8, B_pad=2)
    assert total == 5
    assert tok.tolist() == [11, 12, 13, 21, 22, 0, 0, 0]
    assert pos.tolist() == [0, 1, 2, 0, 1, 0, 0, 0]
    assert seg.tolist() == [1, 1, 1, 2, 2, 0, 0, 0]
    assert pg.tolist() == [4, 4, 5, 6, 6, -1, -1, -1]
    assert sl.tolist() == [0, 1, 0, 0, 1, 0, 0, 0]
    assert last.tolist() == [2, 4]
    *_, img, _, _ = native.pack_prefill([[1, -200, -200, 2], [-200, 3]], [[0], [1]], 8, 8, 2,
                                        image_token=-200)
    assert img.tolist() == [0, 0, 1, 0, 2, 0, 0, 0]


@pytest.mark.parametrize("args", [
    ([[1, 2, 3]], [[0]], 2, 8, 1),  # outruns its page table
    ([[1] * 5, [2] * 4], [[0, 1, 2], [3, 4]], 2, 8, 2),  # past T_pad
    ([[1], [2], [3]], [[0], [1], [2]], 2, 8, 2),  # past B_pad
])
def test_pack_prefill_overflow_raises(args):
    for fn in (native.pack_prefill, native.pack_prefill_plain):
        with pytest.raises(ValueError, match="overflow"):
            fn(*args)


@pytest.mark.parametrize("fn,args", [
    ("pack_decode", ([1, 2, 3], [4, 5, 6], [[0], [1], [2]], 2, 1)),  # past B_pad
    ("pack_decode", ([1, 2], [4, 5], [[0]], 2, 1)),  # a page table short
    ("pack_prefill", ([[1], [2]], [[0]], 2, 8, 2)),  # a page table short
])
def test_mismatched_lengths_raise(fn, args):
    """Both versions refuse a batch the C side would read or write past."""
    for f in (getattr(native, fn), getattr(native, f"{fn}_plain")):
        with pytest.raises((ValueError, IndexError)):
            f(*args)


def test_random_batches_match():
    """Seeded random decode and chunked-prefill batches, bit for bit."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        B = int(rng.integers(1, 9))
        maxP = int(rng.integers(1, 6))
        tables = [rng.integers(0, 100, rng.integers(0, 8)).tolist() for _ in range(B)]
        args = (rng.integers(0, 1000, B).tolist(), rng.integers(1, 500, B).tolist(), tables,
                B + int(rng.integers(0, 3)), maxP)
        _same(native.pack_decode(*args), native.pack_decode_plain(*args))
        bs = int(rng.choice([2, 4, 16]))
        starts = rng.integers(0, 20, B).tolist()
        prompts = [rng.choice([-200, 1, 2, 3, 4], rng.integers(0, 10)).tolist() for _ in range(B)]
        ptables = [rng.integers(0, 100, (s + len(p)) // bs + 1).tolist()
                   for s, p in zip(starts, prompts)]
        T_pad = sum(map(len, prompts)) + int(rng.integers(0, 5))
        args = (prompts, ptables, bs, T_pad, B)
        kw = dict(image_token=-200, starts=starts)
        _same(native.pack_prefill(*args, **kw), native.pack_prefill_plain(*args, **kw))


def test_concurrent_first_builds_load(tmp_path):
    """Two processes building into one empty directory at once both load a
    whole library; one library is left and no temporary file."""
    code = (
        "import sys\n"
        "from qserve_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "assert native.get_lib() is not None\n"
        "t, c, b = native.pack_decode([7], [3], [[4, 5]], 2, 2)\n"
        "assert b.tolist() == [[4, 5], [0, 0]]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop(native.SWITCH, None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and out.splitlines()[-1] == "ok", err
    assert [f for f in os.listdir(tmp_path)] == [os.path.basename(native.library_path())]


def test_switch_takes_the_numpy_path(monkeypatch):
    calls = []
    real = native.pack_decode_plain
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv(native.SWITCH, "1")
    monkeypatch.setattr(native, "pack_decode_plain", lambda *a: calls.append(a) or real(*a))
    assert native.get_lib() is None
    _same(native.pack_decode([9], [3], [[2, 8]], 4, 3), real([9], [3], [[2, 8]], 4, 3))
    assert len(calls) == 1


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "marshal.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv(native.SWITCH, raising=False)
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ .* failed"):
        native.get_lib()
    with pytest.raises(RuntimeError):
        native.pack_decode([1], [1], [[0]], 1, 1)
