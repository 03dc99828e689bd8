"""WikiText-2-style perplexity evaluation (qserve_tpu/eval/ppl.py).

The protocol the reference's published numbers use (DeepCompressor,
README.md:371-389: eval seqlen 2048, non-overlapping windows over the
concatenated corpus), run in-framework: the model forward is the serving
path (quantized GEMMs, int8 activation handoffs, the prefill attention
kernel on the card), only the KV cache is bypassed.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from qserve_tpu_torch.logger import init_logger
from qserve_tpu_torch.models import llama

logger = init_logger(__name__)


def tokenize_text(tokenizer, text: str) -> np.ndarray:
    """Concatenated corpus -> int32 token ids (BOS prepended once)."""
    ids = tokenizer.encode(text)
    return np.asarray(ids, dtype=np.int32)


def evaluate_ppl(
    params: llama.LlamaParams,
    args: llama.LlamaArgs,
    token_ids: np.ndarray,
    seqlen: int = 2048,
    max_windows: Optional[int] = None,
    row_chunk: int = 256,
    progress: bool = False,
    simulate_kv_quant: bool = False,
) -> float:
    """PPL over non-overlapping `seqlen` windows of the concatenated corpus,
    on the params' device.

    Each window predicts tokens 1..len-1 given the window prefix (the first
    token of each window is never scored). Every window is padded to the
    same T, a row_chunk multiple; each costs one read-back of its NLL sum
    (the count is known on the host)."""
    n = len(token_ids)
    num_windows = n // seqlen if n >= seqlen else 1
    if max_windows is not None:
        num_windows = min(num_windows, max_windows)
    if num_windows == 0:
        raise ValueError(f"corpus of {n} tokens shorter than one window")

    T = max(seqlen, row_chunk)
    T = -(-T // row_chunk) * row_chunk
    device = params.embed.device

    total_nll = 0.0
    total_cnt = 0
    for wi in range(num_windows):
        chunk = token_ids[wi * seqlen : (wi + 1) * seqlen]
        buf = np.zeros(T, np.int32)
        buf[: len(chunk)] = chunk
        nll, cnt = llama.teacher_forced_nll(
            params, torch.from_numpy(buf).to(device), len(chunk), args,
            row_chunk, simulate_kv_quant,
        )
        total_nll += float(nll)
        total_cnt += cnt
        if progress:
            logger.info(
                "window %d/%d: running ppl %.4f",
                wi + 1, num_windows, math.exp(total_nll / max(total_cnt, 1)),
            )
    return math.exp(total_nll / max(total_cnt, 1))
