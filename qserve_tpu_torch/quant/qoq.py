"""QoQ W4A8KV4 quantization math in plain PyTorch (qserve_tpu/quant/qoq.py).

These are the oracles every kernel of the port is held against, and they
agree bit for bit with the JAX package's versions:

  * activations: per-token symmetric INT8, round half to even (torch.round),
    scale = max(amax, 1e-8) / 127, plus the per-token act-sum scale * sum(q)
    that the per-channel W4 GEMM epilogue consumes;
  * per-channel W4: asymmetric UINT4 with a per-output-channel scale and a
    pre-multiplied scaled zero (s1_szero = scale * zero);
  * KV: per-token, per-head asymmetric UINT4/UINT8 with a float scale and
    offset.

Integer products run in float64, which holds every int8 x uint4 partial sum
exactly (|sum| <= 127 * 15 * K < 2^53), so they need no integer matmul.

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


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product [M, K] x [K, N] -> int32 [M, N]."""
    return (a.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def w4a8_gemm_per_channel_ref(
    a_i8: torch.Tensor,
    a_scale: torch.Tensor,
    a_sum: torch.Tensor,
    p: PerChannelW4,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """out = (A.Q) * s1 * a_scale - s1_szero * a_sum, in that order."""
    psum = (a_i8.to(torch.float64) @ p.qweight.to(torch.float64)).to(torch.float32)
    out = psum * p.s1_scale[None, :] * a_scale - p.s1_szero[None, :] * a_sum
    return out.to(out_dtype)


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
