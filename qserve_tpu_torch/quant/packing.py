"""W4 and KV4 nibble packing, in the JAX package's layouts
(qserve_tpu/quant/packing.py).

Weights live as [K, N]. Two UINT4 values pack into one int8 along K with a
global half-split: packed row r holds K-row r in its low nibble and K-row
r + K/2 in its high nibble. The W4A8 GEMM kernel therefore pairs the low
nibble plane with activation columns [0, K/2) and the high plane with
[K/2, K) and never reassembles [K, N].

KV4 packs along head_dim with the same half-split: dims [0, D/2) in the low
nibble, [D/2, D) in the high nibble.
"""

from __future__ import annotations

import torch


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    """int32 byte values 0..255 -> the same bit pattern in an int8 carrier."""
    return x.to(torch.uint8).view(torch.int8)


def pack_w4(q: torch.Tensor) -> torch.Tensor:
    """Pack UINT4 values (int8 carrier, [K, N]) into [K//2, N] int8."""
    K = q.shape[0]
    assert K % 2 == 0, f"K={K} must be even"
    x = q.to(torch.int32) & 0xF
    lo, hi = x[: K // 2], x[K // 2 :]
    return _to_int8(lo | (hi << 4))


def unpack_w4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_w4: [..., K//2, N] int8 -> [..., K, N] int8, 0..15."""
    x = packed.to(torch.int32)
    lo = x & 0xF
    hi = (x >> 4) & 0xF
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def pack_kv4(q: torch.Tensor) -> torch.Tensor:
    """[..., D] UINT4 values -> [..., D//2] int8, half-split along D."""
    D = q.shape[-1]
    assert D % 2 == 0
    x = q.to(torch.int32) & 0xF
    lo, hi = x[..., : D // 2], x[..., D // 2 :]
    return _to_int8(lo | (hi << 4))


def unpack_kv4(packed: torch.Tensor) -> torch.Tensor:
    """[..., D//2] int8 -> [..., D] int8 values 0..15."""
    x = packed.to(torch.int32)
    lo = x & 0xF
    hi = (x >> 4) & 0xF
    return torch.cat([lo, hi], dim=-1).to(torch.int8)
