"""The traffic generator: deterministic per seed, the declared
distributions, the same work for every seed in another order."""

import numpy as np
import pytest

from qbench import registry
from qbench.traffic import Traffic, gamma_gaps, length_grid

MIXES = ("decode-batch", "doc-batch", "chat-bursty")


def _traffic(name, seed, epoch_s=30.0):
    spec = registry.load_json(f"{registry.QBENCH}/traffic/{name}.json")
    return spec, Traffic(spec, seed, 32000, [0, 1, 2], epoch_s)


def _first(name, seed, n=200):
    spec, t = _traffic(name, seed)
    if spec["loop"] == "closed":
        reqs = t.initial_requests()
        while len(reqs) < n:
            reqs.append(t.next_request(0))
        return spec, reqs[:n]
    ep = t.epochs()
    next(ep)  # the warm-up epoch
    return spec, next(ep)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    _, a = _first(mix, 2**31 + 7)
    _, b = _first(mix, 2**31 + 7)
    assert [r.max_tokens for r in a] == [r.max_tokens for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.due for r in a] == [r.due for r in b]


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_permute_the_same_work(mix):
    spec, a = _first(mix, 5)
    _, b = _first(mix, 6)
    if spec["loop"] == "open":
        # one epoch holds the same multiset of lengths and of gaps
        assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
        assert sorted(r.max_tokens for r in a) == sorted(r.max_tokens for r in b)
        ga, gb = np.diff([r.due for r in a]), np.diff([r.due for r in b])
        assert len(a) == len(b)
        assert abs(ga.sum() - gb.sum()) < 30.0  # each epoch spans 30 s
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert not all(np.array_equal(x.prompt[:8], y.prompt[:8]) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_match_declared(mix):
    spec = registry.load_json(f"{registry.QBENCH}/traffic/{mix}.json")
    for key in ("prompt_len", "output_len"):
        d = spec[key]
        g = length_grid(d, 4001)
        assert g.min() >= d["min"] and g.max() <= d["max"]
        assert abs(np.median(g) - d["median"]) <= 1
        inside = (g > d["min"]) & (g < d["max"])
        # the interior follows the lognormal: log-spread of the middle half
        q1, q3 = np.percentile(np.log(g[inside]), [25, 75])
        assert abs((q3 - q1) / 1.349 - d["sigma"]) < 0.15 * d["sigma"] + 0.05


def test_gaps_match_declared_cv():
    g = gamma_gaps(2.0, 20000, 123)
    assert abs(g.mean() - 1) < 1e-9
    assert abs(g.std() / g.mean() - 2.0) < 0.1


def test_open_loop_epochs_fill_their_span():
    spec, t = _traffic("chat-bursty", 11, epoch_s=30.0)
    ep = t.epochs()
    warm = next(ep)
    assert len(warm) == round(spec["rate_per_s"] * spec["warmup_s"])
    for e in range(1, 3):
        reqs = next(ep)
        start = spec["warmup_s"] + 30.0 * (e - 1)
        assert len(reqs) == round(spec["rate_per_s"] * 30.0)
        due = np.array([r.due for r in reqs])
        assert due[0] == pytest.approx(start) and np.all(np.diff(due) >= 0)
        assert due[-1] < start + 30.0
        greedy = sum(r.greedy for r in reqs)
        assert greedy == len(reqs) // spec["sampling"]["greedy_every"] + (
            len(reqs) % spec["sampling"]["greedy_every"] > 0)


@pytest.mark.parametrize("mix", MIXES)
def test_ids_skip_special_ids(mix):
    _, reqs = _first(mix, 9)
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 3 and ids.max() < 32000


def test_stagger_shortens_first_requests():
    spec, t = _traffic("decode-batch", 4)
    first = t.initial_requests()
    assert len(first) == spec["clients"]
    later = [t.next_request(0) for _ in range(len(first))]
    assert np.mean([r.max_tokens for r in first]) < 0.7 * np.mean([r.max_tokens for r in later])
    assert min(r.max_tokens for r in first) >= 1


@pytest.mark.parametrize("mix", ["decode-batch", "doc-batch"])
def test_every_deck_block_holds_the_same_work(mix):
    spec, t = _traffic(mix, 2**33 + 5)
    b = spec["deck_block"]
    blocks = [t._deck[i:i + b] for i in range(0, 4 * b, b)]
    for blk in blocks:
        assert sorted(p for p, _ in blk) == sorted(p for p, _ in blocks[0])
        assert sorted(o for _, o in blk) == sorted(o for _, o in blocks[0])
    _, u = _traffic(mix, 2**33 + 6)
    assert u._deck[:b] != t._deck[:b]


def test_shape_warmup_covers_the_prompt_range():
    spec, t = _traffic("chat-bursty", 3)
    w = t.shape_warmup(2048)
    lens = sorted(len(r.prompt) for r in w)
    assert lens[-1] == spec["prompt_len"]["max"] > 2048 and lens[0] < spec["prompt_len"]["median"]
    assert any(r.greedy for r in w) and any(not r.greedy for r in w)
    assert min(r.index for r in w) > 10**9
