"""QoQ quantization math in plain PyTorch (qserve_tpu/quant/qoq.py).

These are the oracles every kernel of the port is held against, and they
agree bit for bit with the JAX package's versions:

  * activations: per-token symmetric INT8, round half to even (torch.round),
    scale = max(amax, 1e-8) / 127, plus the per-token act-sum scale * sum(q)
    that the per-channel W4 GEMM epilogue consumes;
  * per-channel W4: asymmetric UINT4 with a per-output-channel scale and a
    pre-multiplied scaled zero (s1_szero = scale * zero);
  * per-group W4: two levels. Level 1 maps a weight onto the INT8 lattice
    with a per-output-channel float scale; level 2 quantizes that INT8 value
    to UINT4 with an integer (uint8 scale, int8 zero) per group, so that
    w8 = q * s2 + z2 is exact int8 arithmetic;
  * W8: symmetric per-output-channel INT8;
  * KV: per-token, per-head asymmetric UINT4/UINT8 with a float scale and
    offset.

Integer products run in float64, which holds every int8 x int8 partial sum
exactly (|sum| <= 128 * 128 * K < 2^53), so they need no integer matmul.

Divisions by a constant go through `_div`: PyTorch's CUDA division by a
Python scalar multiplies by its reciprocal, which can land an ulp off the
true quotient that the JAX package and the kernels compute.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

UINT4_MAX = 15
INT8_MIN = -128
INT8_MAX = 127


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_activation_per_token(
    x: torch.Tensor, with_sum: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """[..., K] float -> (q int8 [..., K], scale f32 [..., 1], sum f32 [..., 1] | None)."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = _div(torch.clamp(amax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(x / scale), INT8_MIN, INT8_MAX)
    s = None
    if with_sum:
        s = q.sum(dim=-1, keepdim=True) * scale  # exact: |sum| < 2^24
    return q.to(torch.int8), scale, s


class PerChannelW4(NamedTuple):
    """Per-channel W4 parameters, [K, N] layout, qweight unpacked."""

    qweight: torch.Tensor  # int8 [K, N], values 0..15
    s1_scale: torch.Tensor  # f32 [N]
    s1_szero: torch.Tensor  # f32 [N]


def quantize_weight_per_channel(w: torch.Tensor) -> PerChannelW4:
    """Asymmetric per-output-channel UINT4 quantization of a [K, N] weight."""
    w = w.to(torch.float32)
    wmax = w.amax(dim=0)
    wmin = w.amin(dim=0)
    scale = _div(torch.clamp(wmax - wmin, min=1e-8), UINT4_MAX)
    zero = torch.clamp(torch.round(-wmin / scale), 0, UINT4_MAX)
    q = torch.clamp(torch.round(w / scale) + zero, 0, UINT4_MAX).to(torch.int8)
    return PerChannelW4(qweight=q, s1_scale=scale, s1_szero=scale * zero)


def dequantize_per_channel(p: PerChannelW4) -> torch.Tensor:
    return p.qweight.to(torch.float32) * p.s1_scale[None, :] - p.s1_szero[None, :]


class PerGroupW4(NamedTuple):
    """Per-group two-level W4 parameters, [K, N] layout, qweight unpacked."""

    qweight: torch.Tensor  # int8 [K, N], values 0..15
    s2_scale: torch.Tensor  # uint8 values in an int8 carrier [K//G, N]
    s2_zero: torch.Tensor  # int8 [K//G, N]
    s1_scale: torch.Tensor  # f32 [N]


class W8(NamedTuple):
    """Symmetric per-channel INT8 weights, [K, N] layout."""

    qweight: torch.Tensor  # int8 [K, N]
    scale: torch.Tensor  # f32 [N]


def quantize_weight_per_group(w: torch.Tensor, group_size: int = 128) -> PerGroupW4:
    """Two-level progressive quantization of a [K, N] weight; K must be
    divisible by group_size."""
    K, N = w.shape
    assert K % group_size == 0, f"K={K} not divisible by group_size={group_size}"
    G = K // group_size
    w = w.to(torch.float32)

    # level 1: per-channel float scale onto the int8 range
    s1 = _div(torch.clamp(w.abs().amax(dim=0), min=1e-8), 127.0)
    wg = (w / s1[None, :]).reshape(G, group_size, N)

    # level 2: per-group integer scale >= 1 and zero, chosen so that
    # q * s2 + z2 stays an int8 for every q in [0, 15]
    gmax, gmin = wg.amax(dim=1), wg.amin(dim=1)
    s2 = torch.ceil(_div(torch.clamp(gmax - gmin, min=1e-8), UINT4_MAX))
    s2 = torch.clamp(s2, 1, 255)
    z2 = torch.clamp(torch.round(gmin), INT8_MIN, INT8_MAX)
    s2 = torch.minimum(s2, torch.floor(_div(127.0 - z2, UINT4_MAX)))
    s2 = torch.clamp(s2, min=1.0)
    q = torch.round((wg - z2[:, None, :]) / s2[:, None, :])
    q = torch.clamp(q, 0, UINT4_MAX).to(torch.int8).reshape(K, N)
    return PerGroupW4(
        qweight=q,
        s2_scale=s2.to(torch.int32).to(torch.uint8).view(torch.int8),
        s2_zero=z2.to(torch.int8),
        s1_scale=s1,
    )


def pergroup_level2_int8(p: PerGroupW4, group_size: int = 128) -> torch.Tensor:
    """Level-2 reconstruction: the INT8 intermediate weights [K, N]. Off the
    quantizer's lattice q * s2 + z2 wraps to int8, as a cast does."""
    K, N = p.qweight.shape
    G = K // group_size
    q = p.qweight.reshape(G, group_size, N).to(torch.int32)
    s2 = p.s2_scale.to(torch.int32) & 0xFF  # uint8 semantics
    w8 = q * s2[:, None, :] + p.s2_zero.to(torch.int32)[:, None, :]
    w8 = ((w8 + 128) & 0xFF) - 128
    return w8.reshape(K, N).to(torch.int8)


def dequantize_per_group(p: PerGroupW4, group_size: int = 128) -> torch.Tensor:
    w8 = pergroup_level2_int8(p, group_size).to(torch.float32)
    return w8 * p.s1_scale[None, :]


def quantize_weight_w8(w: torch.Tensor) -> W8:
    """Symmetric per-output-channel INT8 quantization of a [K, N] weight."""
    w = w.to(torch.float32)
    scale = _div(torch.clamp(w.abs().amax(dim=0), min=1e-8), 127.0)
    q = torch.clamp(torch.round(w / scale), INT8_MIN, INT8_MAX).to(torch.int8)
    return W8(qweight=q, scale=scale)


def dequantize_w8(p: W8) -> torch.Tensor:
    return p.qweight.to(torch.float32) * p.scale[None, :]


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product [M, K] x [K, N] -> int32 [M, N]."""
    return (a.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def _int_psum(a_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Exact integer product [M, K] x [K, N], rounded once to f32 (as an
    int32 accumulator converts)."""
    return (a_i8.to(torch.float64) @ w_i8.to(torch.float64)).to(torch.float32)


def w4a8_gemm_per_channel_ref(
    a_i8: torch.Tensor,
    a_scale: torch.Tensor,
    a_sum: torch.Tensor,
    p: PerChannelW4,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """out = (A.Q) * s1 * a_scale - s1_szero * a_sum, in that order."""
    psum = _int_psum(a_i8, p.qweight)
    out = psum * p.s1_scale[None, :] * a_scale - p.s1_szero[None, :] * a_sum
    return out.to(out_dtype)


def w4a8_gemm_per_group_ref(
    a_i8: torch.Tensor,
    a_scale: torch.Tensor,
    p: PerGroupW4,
    group_size: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """out = (A . (Q * s2 + z2)) * s1 * a_scale, in that order."""
    psum = _int_psum(a_i8, pergroup_level2_int8(p, group_size))
    return (psum * p.s1_scale[None, :] * a_scale).to(out_dtype)


def w8a8_gemm_ref(
    a_i8: torch.Tensor, a_scale: torch.Tensor, p: W8, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """out = (A . W) * w_scale * a_scale, in that order."""
    return (_int_psum(a_i8, p.qweight) * p.scale[None, :] * a_scale).to(out_dtype)


def quantize_kv(
    x: torch.Tensor, bits: int = 4, asymmetric: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize K or V along head_dim. Returns (q int8 carrier, scale, zero),
    scale/zero [..., 1]; reconstruction x_hat = q * scale + zero."""
    x = x.to(torch.float32)
    qmax = (1 << bits) - 1
    if asymmetric:
        mx = x.amax(dim=-1, keepdim=True)
        mn = x.amin(dim=-1, keepdim=True)
        scale = _div(torch.clamp(mx - mn, min=1e-8), qmax)
        zero = mn
        q = torch.clamp(torch.round((x - mn) / scale), 0, qmax)
    else:
        amax = x.abs().amax(dim=-1, keepdim=True)
        half = qmax // 2
        scale = _div(torch.clamp(amax, min=1e-8), half)
        zero = torch.zeros_like(amax)
        q = torch.clamp(torch.round(x / scale), -half - 1, half)
    # unsigned lattice values keep their bit pattern in an int8 byte
    q = q.to(torch.int32).to(torch.uint8).view(torch.int8)
    return q, scale, zero


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """x_hat = q * scale + zero, q read as an unsigned byte."""
    qu = q.to(torch.int32) & 0xFF
    return qu.to(torch.float32) * scale + zero
