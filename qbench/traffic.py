"""The one traffic generator: every mix is a data file in qbench/traffic/.

A mix is a closed loop (a fixed number of clients, each sending its next
request when its last one finishes) or an open loop (requests due on a
schedule, whether or not earlier ones have finished). Lengths come from a
clipped lognormal given by its median and sigma; arrival gaps of an open
loop from a gamma distribution given by its coefficient of variation.

Every seed serves the same work in another order. Lengths are read off a
fixed quantile grid of their distribution, so each seed draws the same
multiset, and the seed only permutes and pairs them. A closed loop's deck
is made of blocks of `deck_block` requests, each block the same multiset
of prompt and of output lengths, so that any stretch of the deck a window
consumes holds nearly the same work whatever the seed. An open loop runs in
epochs of the window's length after a warm-up epoch: each holds the same
number of arrivals, the same multiset of gaps (drawn once from the file's
`deck_seed`, scaled to fill the epoch exactly) and the same multiset of
lengths, in an order the seed and the epoch's index choose. Token ids are
uniform over the vocabulary without its special ids, drawn per request from
the seed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import statistics
from typing import Iterator, List, Optional, Tuple

import numpy as np

_U64 = (1 << 64) - 1
WARMUP_INDEX = 1 << 40  # shape warm-up requests are numbered from here


@dataclasses.dataclass
class RequestSpec:
    index: int  # the request's number in this run (0, 1, 2, ...)
    prompt: np.ndarray  # int32 token ids
    max_tokens: int
    temperature: float
    top_p: float
    client: Optional[int] = None  # closed loop: the client that sends it
    due: Optional[float] = None  # open loop: seconds after the schedule's start

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def length_grid(spec: dict, n: int) -> np.ndarray:
    """n lengths at the quantiles (j + 0.5) / n of the clipped lognormal."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((j + 0.5) / n) for j in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def gamma_gaps(cv: float, n: int, deck_seed: int) -> np.ndarray:
    """n gamma gaps of coefficient of variation cv, mean 1, from deck_seed."""
    shape = 1.0 / (cv * cv)
    g = np.random.default_rng(deck_seed).gamma(shape, 1.0 / shape, size=n)
    return g / g.mean()


class Traffic:
    """The requests of one run of one mix."""

    def __init__(self, spec: dict, seed: int, vocab_size: int,
                 special_ids: List[int], epoch_s: float) -> None:
        self.spec = spec
        self.seed = int(seed) & _U64
        self.vocab_size = int(vocab_size)
        special = sorted(set(int(i) for i in special_ids))
        if special != list(range(len(special))):
            raise ValueError("special ids must be the lowest ids of the vocabulary")
        self.low_id = len(special)
        self.epoch_s = float(epoch_s)
        self.loop = spec["loop"]
        self.n_sent = 0
        samp = spec["sampling"]
        self._temp = float(samp["temperature"])
        self._top_p = float(samp["top_p"])
        self._greedy_every = int(samp["greedy_every"])
        if self.loop == "closed":
            b = int(spec["deck_block"])
            p = length_grid(spec["prompt_len"], b)
            o = length_grid(spec["output_len"], b)
            rng = self._rng("deck")
            self._deck = [pair for _ in range(int(spec["deck_size"]) // b)
                          for pair in zip(p[rng.permutation(b)], o[rng.permutation(b)])]
        elif self.loop != "open":
            raise ValueError(f"unknown loop {self.loop!r}")

    # ------------------------------------------------------------------
    def _rng(self, *tags) -> np.random.Generator:
        words = [self.seed] + [t if isinstance(t, int) else _tag(t) for t in tags]
        return np.random.default_rng(np.random.SeedSequence(words))

    def _prompt(self, index: int, length: int) -> np.ndarray:
        rng = self._rng("ids", index)
        return rng.integers(self.low_id, self.vocab_size, size=int(length), dtype=np.int32)

    def _sampling(self, k: int) -> Tuple[float, float]:
        """Every greedy_every-th request of a run (by k) is greedy."""
        if self._temp == 0.0 or k % self._greedy_every == 0:
            return 0.0, 1.0
        return self._temp, self._top_p

    def _make(self, k: int, prompt_len: int, out_len: int, greedy_slot: int,
              **where) -> RequestSpec:
        temp, top_p = self._sampling(greedy_slot)
        return RequestSpec(index=k, prompt=self._prompt(k, prompt_len),
                           max_tokens=int(out_len), temperature=temp, top_p=top_p, **where)

    def shape_warmup(self, budget: int) -> List[RequestSpec]:
        """Requests that run every step kind of the mix once before its
        schedule starts (first launches, allocator growth): prompts at the
        deciles of the mix's prompt length, the longest one as well (chunked
        past `budget`), 8 output tokens each, greedy and sampled alike. Ids
        are drawn from the seed apart from the traffic's."""
        d = self.spec["prompt_len"]
        lens = list(length_grid(d, 9)) + [d["max"]]
        out = []
        for j, n in enumerate(lens):
            temp, top_p = self._sampling(j)
            rng = self._rng("warm", j)
            out.append(RequestSpec(index=WARMUP_INDEX + j, max_tokens=8, temperature=temp,
                                   top_p=top_p, prompt=rng.integers(
                                       self.low_id, self.vocab_size, size=int(n), dtype=np.int32)))
        return out

    # ---- closed loop ----------------------------------------------------
    def initial_requests(self) -> List[RequestSpec]:
        """One request for each client. With stagger_first, each first
        request keeps only a share of its output (shares (i + 0.5) / clients
        in the seed's order), so the clients finish at spread times and the
        window sees the steady mix, not a first wave."""
        clients = int(self.spec["clients"])
        shares = (np.arange(clients) + 0.5) / clients
        shares = shares[self._rng("stagger").permutation(clients)]
        out = []
        for c in range(clients):
            r = self.next_request(c)
            if self.spec.get("stagger_first"):
                r.max_tokens = max(1, int(np.ceil(shares[c] * r.max_tokens)))
            out.append(r)
        return out

    def next_request(self, client: int) -> RequestSpec:
        k = self.n_sent
        self.n_sent += 1
        p, o = self._deck[k % len(self._deck)]
        return self._make(k, p, o, k, client=client)

    # ---- open loop ------------------------------------------------------
    def epochs(self) -> Iterator[List[RequestSpec]]:
        """Epoch 0 spans the warm-up (warmup_s), every later one epoch_s;
        yields each epoch's requests, due in order from its start."""
        rate = float(self.spec["rate_per_s"])
        arr = self.spec["arrival"]
        if arr["dist"] != "gamma":
            raise ValueError(f"unknown arrival distribution {arr['dist']!r}")
        start, e = 0.0, 0
        while True:
            span = float(self.spec["warmup_s"]) if e == 0 else self.epoch_s
            m = max(1, int(round(rate * span)))
            gaps = gamma_gaps(float(arr["cv"]), m, int(self.spec["deck_seed"]) + (e > 0)) * (span / m)
            rng = self._rng("epoch", e)
            gaps = gaps[rng.permutation(m)]
            due = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
            p = length_grid(self.spec["prompt_len"], m)[rng.permutation(m)]
            o = length_grid(self.spec["output_len"], m)[rng.permutation(m)]
            greedy_slots = rng.permutation(m)
            reqs = []
            for j in range(m):
                k = self.n_sent
                self.n_sent += 1
                reqs.append(self._make(k, p[j], o[j], int(greedy_slots[j]), due=float(due[j])))
            yield reqs
            start += span
            e += 1


def _tag(s) -> int:
    """A stable integer for a string tag."""
    return int.from_bytes(hashlib.blake2b(str(s).encode(), digest_size=8).digest(), "little")
