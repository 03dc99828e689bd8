"""Per-step batch marshalling on the host (qserve_tpu/native/__init__.py).

The numpy path of the JAX package's marshal; its g++/ctypes fast path is a
later item (ROADMAP queue 1, the native marshal).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def pack_decode(
    last_tokens: Sequence[int],
    ctx_lens: Sequence[int],
    tables: Sequence[Sequence[int]],
    B_pad: int,
    maxP: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (tokens [B_pad], ctx [B_pad], block_table [B_pad, maxP])."""
    n = len(last_tokens)
    out_tok = np.zeros(B_pad, np.int32)
    out_ctx = np.zeros(B_pad, np.int32)
    out_bt = np.zeros((B_pad, maxP), np.int32)
    out_tok[:n] = last_tokens
    out_ctx[:n] = ctx_lens
    for i, t in enumerate(tables):
        out_bt[i, : min(len(t), maxP)] = t[:maxP]
    return out_tok, out_ctx, out_bt


def pack_prefill(
    prompts: Sequence[Sequence[int]],
    tables: Sequence[Sequence[int]],
    block_size: int,
    T_pad: int,
    B_pad: int,
    image_token: Optional[int] = None,
    starts: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, ...]:
    """-> (tokens, positions, segids, pages, slots, img_idx [T_pad],
           last_idx [B_pad], total_tokens).

    starts: absolute start position per prompt (chunked prefill — `prompts`
    then holds only the chunk's tokens); None = all prompts start at 0."""
    n = len(prompts)
    outs = [np.empty(T_pad, np.int32) for _ in range(6)]
    last_idx = np.empty(B_pad, np.int32)
    itok = np.int32(image_token) if image_token is not None else np.int32(-(2**31))
    st = np.ascontiguousarray(
        starts if starts is not None else np.zeros(n, np.int32), dtype=np.int32
    )
    total = sum(len(p) for p in prompts)
    if n > B_pad or total > T_pad or any(
        p and (int(st[i]) + len(p) - 1) // block_size >= len(tables[i])
        for i, p in enumerate(prompts)
    ):
        raise ValueError(
            f"pack_prefill overflow: {n} prompts ({total} tokens) do not fit "
            f"T_pad={T_pad} / B_pad={B_pad} or a page table is too short"
        )
    tokens, positions, segids, pages, slots, img_idx = outs
    tokens[:] = 0
    positions[:] = 0
    segids[:] = 0
    pages[:] = -1
    slots[:] = 0
    img_idx[:] = 0
    last_idx[:] = 0
    t = 0
    n_img = 0
    for i, prompt in enumerate(prompts):
        table = tables[i]
        s0 = int(st[i])
        for p, tok in enumerate(prompt):
            tokens[t] = tok
            positions[t] = s0 + p
            segids[t] = i + 1
            pages[t] = table[(s0 + p) // block_size]
            slots[t] = (s0 + p) % block_size
            if tok == itok:
                img_idx[t] = n_img
                n_img += 1
            t += 1
        last_idx[i] = t - 1
    return (tokens, positions, segids, pages, slots, img_idx, last_idx, t)
