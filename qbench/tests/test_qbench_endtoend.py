"""The end-to-end arithmetic on synthetic timestamps: a stall injected into
the window moves ttft_p95_ms and tpot_p95_ms, a failed request counts as a
miss, tokens count when their step returns."""

import numpy as np
import pytest

from qbench import registry
from qbench.harness import Request, Step
from qbench.run import RunView
from qbench.traffic import RequestSpec


def _req(i, due, first, last, n_out, max_tokens=None, done=True):
    spec = RequestSpec(index=i, prompt=np.zeros(8, np.int32),
                       max_tokens=max_tokens or n_out, temperature=0.0, top_p=1.0)
    return Request(spec=spec, rid=str(i), due=due, first=first, last=last,
                   done=last if done else None, n_out=n_out)


def _view(reqs, steps=(), t0=0.0, t1=10.0):
    return RunView(sizes=None, family=None, kv_pages=200, t0=t0, t1=t1, setup_s=3.5,
                   window=list(steps), traced=[], trace=None, due=reqs,
                   finished=[r for r in reqs if r.done is not None])


def _e2e(name):
    return registry.load_module("e2e", name).read


def _steady(n=200, stall_at=None, stall=0.0):
    """n requests due every 0.05 s, first token 0.1 s later, 100 tokens
    0.02 s apart; a stall of `stall` seconds at stall_at delays every token
    after it."""
    reqs = []
    for i in range(n):
        due = 0.05 * i
        first = due + 0.1
        last = first + 99 * 0.02
        if stall_at is not None:
            first += stall if first >= stall_at else 0.0
            last += stall if last >= stall_at else 0.0
        reqs.append(_req(i, due, first, last, 100))
    return reqs


def test_ttft_and_tpot_on_steady_requests():
    v = _view(_steady())
    assert _e2e("ttft_p95_ms")(v) == pytest.approx(100.0)
    assert _e2e("tpot_p95_ms")(v) == pytest.approx(20.0)


def test_a_stall_moves_both_tails():
    base = _view(_steady())
    stalled = _view(_steady(stall_at=8.0, stall=1.5))
    assert _e2e("ttft_p95_ms")(stalled) > _e2e("ttft_p95_ms")(base) + 500
    assert _e2e("tpot_p95_ms")(stalled) > _e2e("tpot_p95_ms")(base) + 10


def test_a_failed_request_counts_as_a_miss():
    reqs = _steady(100)
    ok = _e2e("ttft_p95_ms")(_view(reqs))
    for r in reqs[:6]:  # six of a hundred fail: past the 95th percentile
        r.n_out = 3  # finished short of max_tokens: failed
    assert _e2e("ttft_p95_ms")(_view(reqs)) == 1e9
    reqs = _steady(10)
    reqs[0].first = None  # one of ten never got its first token: a miss at p95
    reqs[0].done = None
    assert _e2e("ttft_p95_ms")(_view(reqs)) == 1e9
    assert _e2e("ttft_p95_ms")(_view(_steady(10))) == pytest.approx(ok)


def test_output_rate_counts_tokens_of_window_steps():
    steps = [Step(t0=0.1 * i, t1=0.1 * i + 0.1, kind="decode", launches=0, decode_ctx=[],
                  spans=[], logit_rows=0, new_tokens=64, pages_used=0) for i in range(100)]
    v = _view([], steps, t0=0.0, t1=10.0)
    assert _e2e("output_tok_s")(v) == pytest.approx(640.0)
    assert _e2e("setup_s")(v) == 3.5


def test_kv_pages_peak_is_the_fullest_step_over_the_cache():
    steps = [Step(t0=i, t1=i + 1, kind="decode", launches=0, decode_ctx=[], spans=[],
                  logit_rows=0, new_tokens=1, pages_used=u) for i, u in enumerate((30, 75, 40))]
    read = registry.load_module("metrics", "kv_pages_peak.batch").read
    assert read(_view([], steps)) == pytest.approx(37.5)
    assert read(_view([], [])) is None


def test_check_sample_spans_the_admissions_with_the_longest_in_it():
    from qbench import check

    reqs = []
    for i in range(40):
        r = _req(i, due=float(i), first=i + 1.0, last=i + 2.0, n_out=50 + (i * 37) % 90)
        r.tokens = list(range(r.n_out))
        reqs.append(r)
    longest = max(reqs, key=lambda r: len(r.tokens))
    for seed in (1, 2**31 + 5):
        picked = check.sample(reqs, seed, 6)
        assert picked[0] is longest and len({id(r) for r in picked}) == 6
        # then one from each of five equal spans of the rest, in the order due
        rest = sorted((r for r in reqs if r is not longest), key=lambda r: r.due)
        spans = [rest[a:a + 8] for a in (0, 8, 16, 24, 32)]
        assert all(any(p is q for q in span) for p, span in zip(picked[1:], spans))
    assert check.sample(reqs, 1, 6) == check.sample(reqs, 1, 6)
    assert check.sample(reqs, 1, 6) != check.sample(reqs, 3, 6)
    assert len(check.sample(reqs[:3], 1, 6)) == 3
    served = check.served_of(picked[1], 64)
    assert served.scored == min(64, len(picked[1].tokens))
