"""The W4A8 per-channel GEMM (K2, `kernels/gemm.py`; and its routed form,
K10, for MoE streams): operations and bytes that the inputs need.

A launch over M live rows of a [K, N] weight needs 2 M K N int8 operations
and reads the packed weight (K N / 2 bytes), its two f32 vectors (scale,
scaled zero), the M int8 rows and their two f32 per-row factors (scale,
act-sum), and writes M bf16 rows: each byte once. Only live rows count:
padding rows of a bucketed batch, and the rows of experts a token was not
routed to, are work the inputs do not need. So the masked MoE loop, which
runs every expert over every row, shows as waste against this bound.

An MoE layer's routed rows are k per token; the experts whose weights are
needed are those some token chose, counted at the expectation of uniform
routing, NE (1 - ((NE - k) / NE)^T) (the random routers here route near
uniformly; at T >= 16 rows that is within 1% of all NE experts).
"""

from qbench.roofline.peaks import bound_s

KERNELS = ("w4a8_gemm_per_chn",)  # K2 and the routed K10 both hold this name


def w4a8_bytes(m: int, k: int, n: int, weights: float = 1.0) -> float:
    return weights * (k * n / 2 + 2 * n * 4) + m * k + 2 * m * 4 + m * n * 2


def w4a8_ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def live_tokens(step) -> int:
    return sum(e - s for s, e in step.spans) + len(step.decode_ctx)


def expected_experts(t: int, n_exp: int, top_k: int) -> float:
    return n_exp * (1.0 - ((n_exp - top_k) / n_exp) ** t)


def dense_bound_s(t: int, shape) -> float:
    """The least time of one launch over t live rows of a [K, N] weight."""
    return bound_s(w4a8_bytes(t, *shape), w4a8_ops(t, *shape))


def routed_bound_s(t: int, n_exp: int, top_k: int, shape) -> float:
    """The least time of one routed launch over t tokens' top-k rows, the
    weights of the experts they are expected to choose read once each."""
    rows = top_k * t
    used = expected_experts(t, n_exp, top_k)
    return bound_s(w4a8_bytes(rows, *shape, weights=used), w4a8_ops(rows, *shape))
