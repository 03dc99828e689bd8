"""The model's operations in a step, for the whole step's share of the
int8 peak (MFU).

Each live token costs 2 x the multiplying parameters active for it:
qkv and o, and the dense MLP or the router and its top-k experts. Each
logit row (a prompt's last token, a decode row) costs 2 E V more for the
lm_head. Attention costs 4 Hq D c a token a layer (QK^T and PV) at its real
context c: a prompt token at position p sees p + 1 keys, a decode row its
context; the sliding window caps both.
"""

from qbench.roofline.gemm import live_tokens


def params_per_token_layer(sz) -> int:
    shapes = sz.linear_shapes()
    n = sum(k * m for k, m in (shapes["qkv"], shapes["o"]))
    mlp = sum(k * m for k, m in (shapes["gate_up"], shapes["down"]))
    if sz.experts:
        return n + sz.hidden * sz.experts + sz.top_k * mlp
    return n + mlp


def _ctx_sum(start: int, end: int, window) -> int:
    """Sum over positions p in [start, end) of min(p + 1, window)."""
    if window is None or end <= window:
        return (end * (end + 1) - start * (start + 1)) // 2
    cut = max(start, min(end, window))
    return (cut * (cut + 1) - start * (start + 1)) // 2 + (end - cut) * window


def step_ops(step, sz) -> float:
    t = live_tokens(step)
    ctx = sum(_ctx_sum(s, e, sz.window) for s, e in step.spans)
    ctx += sum(c if sz.window is None else min(c, sz.window) for c in step.decode_ctx)
    return (2.0 * t * sz.layers * params_per_token_layer(sz)
            + 2.0 * step.logit_rows * sz.hidden * sz.vocab
            + 4.0 * sz.heads * sz.head_dim * ctx * sz.layers)
