"""What every family's plain reference shares: the served sequences it runs
over, f32 products with TF32 off, and the gaps a served token is judged by.

A family's reference (qbench/reference/<model_type>.py) takes its float
weights from the benchmark's own maker, quantizes them again by the frozen
copy of the QoQ arithmetic (qoq_frozen.py) and imports nothing of the
program. Its `served_logits(seqs)` returns, for each sequence, the logits
at the positions that produced its last `scored` served tokens.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class Served:
    prompt: np.ndarray  # prompt ids
    tokens: np.ndarray  # the served tokens, in order
    chunk_ends: List[int]  # where each prompt step's span ended
    scored: int  # the last this many served tokens are judged

    @property
    def length(self) -> int:
        """Positions the forward runs over: the prompt and every served
        token but the last (which no step read)."""
        return len(self.prompt) + len(self.tokens) - 1

    def segments(self) -> np.ndarray:
        """The step of each position: a prompt chunk's positions share one,
        each decoded position has its own."""
        n, seg = len(self.prompt), np.empty(self.length, np.int64)
        start = 0
        for i, end in enumerate(self.chunk_ends):
            seg[start:end] = i
            start = end
        if start != n:
            raise ValueError(f"prompt spans end at {start}, the prompt at {n}")
        seg[n:] = len(self.chunk_ends) + np.arange(self.length - n)
        return seg


@contextlib.contextmanager
def exact_f32():
    """f32 products with TF32 off, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def served_gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each token's logit lies below the reference's best."""
    t = torch.as_tensor(tokens, dtype=torch.int64).to(logits.device)
    return logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]
