"""The model's operations in a step, for the whole step's share of the
int8 peak (MFU).

Each live token costs 2 x the multiplying parameters active for it in each
layer (the family counts them: qkv and o, and the dense MLP or the router
and its top-k experts). Each logit row (a prompt's last token, a decode
row) costs 2 E V more for the lm_head. Attention costs 4 Hq D a key a
token a layer (QK^T and PV) at its real context c: a prompt token at
position p sees p + 1 keys, a decode row its context; a layer's attention
window caps both.
"""

from qbench.roofline.gemm import live_tokens


def ctx_sum(start: int, end: int, window) -> int:
    """Sum over positions p in [start, end) of min(p + 1, window)."""
    if window is None or end <= window:
        return (end * (end + 1) - start * (start + 1)) // 2
    cut = max(start, min(end, window))
    return (cut * (cut + 1) - start * (start + 1)) // 2 + (end - cut) * window


def attended_keys(step, window) -> int:
    """The keys the step's live tokens attend to in one layer whose window
    is `window` (None: all)."""
    ctx = sum(ctx_sum(s, e, window) for s, e in step.spans)
    ctx += sum(c if window is None else min(c, window) for c in step.decode_ctx)
    return ctx


def step_ops(step, sz, params_per_token_layer: int, keys: int) -> float:
    """`keys`: attended_keys summed over the layers."""
    t = live_tokens(step)
    return (2.0 * t * sz.layers * params_per_token_layer
            + 2.0 * step.logit_rows * sz.hidden * sz.vocab
            + 4.0 * sz.heads * sz.head_dim * keys)
