"""Paged decode attention (K4, `kernels/paged_attention.py`): the bytes a
decode row needs, once each, per layer.

A row whose context is c tokens (the current one included) reads the c - 1
cached keys and values of each kv head as KV4 or KV8 codes with their
scale and zero (bf16 when 2 * kv_heads is a multiple of 16, else f32), the
current token's exact bf16 k and v, its bf16 query, its block table
(int32 a page), and writes its bf16 output. Query heads that share a kv
head read it once. The bound is those bytes at the HBM rate: the
operations (4 Hq D c a row) fit under them on the tensor cores.
"""

from qbench.roofline.peaks import HBM_BPS

KERNELS = ("paged_decode",)  # the split kernel and its merge


def row_bytes(ctx: int, sz) -> float:
    hist = max(ctx - 1, 0)
    scale_bytes = 2 if (2 * sz.kv_heads) % 16 == 0 else 4
    codes = 2 * hist * sz.kv_heads * sz.head_dim * sz.kv_bits / 8
    scales = 2 * hist * sz.kv_heads * 2 * scale_bytes
    cur = 2 * sz.kv_heads * sz.head_dim * 2
    q_o = 2 * sz.heads * sz.head_dim * 2
    table = -(-ctx // sz.page) * 4
    return codes + scales + cur + q_o + table


def bound_s(ctxs, sz, layers: int) -> float:
    """The least time of `layers` layers' K4 launches over decode rows of
    these contexts."""
    return layers * sum(row_bytes(c, sz) for c in ctxs) / HBM_BPS
