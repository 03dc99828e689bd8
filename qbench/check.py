"""Whether what the timed path served is correct: the reference's logits at
the served positions of a sample of finished requests.

The reference is the configuration's model family's (qbench/families/).
The sample is drawn from the seed among the greedy requests that finished
in the window (and the traced stretch after it): the one with the most
served tokens, then one from each of `check.requests - 1` equal spans of
the rest taken in the order they were due (admitted), so the sample holds
rows from across the batch. The reference runs over each whole sequence
and judges its last `check.scored_tokens` served tokens: for each, the gap
by which its logit lies below the reference's best at that position (0
where the program chose the reference's argmax). The readings of those
gaps are compared with the cell's limits (qbench/limits/<cell>.json), which
PERF.md derives from the program's readings over a dozen seeds and the
control's.

The control is the reference one precision lower (int4 activations for the
int8 that W4A8 states): its first choice at each of the same positions,
judged by the same gaps and limits. The benchmark's runs never compute it;
qbench/calibrate.py and the card test do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from qbench.reference.served import Served, served_gaps
from qbench.weights import WeightMaker, derive_seed

CONTROL_ACT_BITS = 4

READINGS = {"logit_gap": lambda g: float(g.max()), "mean_gap": lambda g: float(g.mean())}


def sample(requests, seed: int, n: int) -> List:
    cands = [r for r in requests
             if r.tokens and r.spec.greedy and not r.irregular and not r.failed]
    if not cands:
        return []
    cands.sort(key=lambda r: (-len(r.tokens), r.spec.index))
    rest = sorted(cands[1:], key=lambda r: (r.due, r.spec.index))
    k = min(n - 1, len(rest))
    rng = np.random.default_rng(derive_seed(seed, "check"))
    spans = np.array_split(np.arange(len(rest)), k) if k > 0 else []
    return [cands[0]] + [rest[int(s[rng.integers(len(s))])] for s in spans]


def served_of(r, scored: int) -> Served:
    return Served(prompt=np.asarray(r.spec.prompt, np.int64),
                  tokens=np.asarray(r.tokens, np.int64), chunk_ends=list(r.chunk_ends),
                  scored=min(scored, len(r.tokens)))


def token_gaps(family, cfg: dict, seed: int, picked, device, scored: int,
               control: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's gaps at the judged positions of the picked requests:
    of the served tokens ("program") and, with `control`, of the control's
    first choices ("control")."""
    maker = WeightMaker(seed, cfg, device, family.sizes(cfg))
    seqs = [served_of(r, scored) for r in picked]
    ref = family.Reference(maker).served_logits(seqs)
    out = {"program": torch.cat([served_gaps(lg, s.tokens[-s.scored:])
                                 for lg, s in zip(ref, seqs)])}
    if control:
        ctl = family.Reference(maker, act_bits=CONTROL_ACT_BITS).served_logits(seqs)
        out["control"] = torch.cat([served_gaps(lg, c.argmax(dim=-1))
                                    for lg, c in zip(ref, ctl)])
    return out


def judge(cell, gaps: Optional[torch.Tensor], n_requests: int) -> Tuple[bool, dict]:
    """(correct, the numbers compared with their limits)."""
    n = 0 if gaps is None else int(gaps.numel())
    checks, correct = {}, n > 0
    for name, lim in cell.limits.items():
        value = READINGS[name](gaps) if n else None
        checks[name] = {"value": value, "limit": float(lim["limit"]), "tokens": n,
                        "requests": n_requests}
        correct = correct and value is not None and value <= float(lim["limit"])
    return correct, checks


def check(cell, seed: int, requests, device) -> Tuple[bool, dict]:
    spec = cell.traffic["check"]
    picked = sample(requests, seed, int(spec["requests"]))
    gaps = (token_gaps(cell.family, cell.config, seed, picked, device,
                       int(spec["scored_tokens"]))["program"] if picked else None)
    return judge(cell, gaps, len(picked))
