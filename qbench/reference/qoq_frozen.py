"""A frozen copy of the QoQ quantization arithmetic, for the reference.

Copied from the port's quant/qoq.py (itself the JAX package's arithmetic)
so that a later change to the program cannot move the yardstick. Plain
PyTorch, f32, on whatever device the tensors are.

  * activations: per-token symmetric, round half to even,
    scale = max(amax, 1e-8) / qmax (qmax 127 at 8 bits, 7 at 4);
  * per-channel W4: asymmetric UINT4 per output channel, scale =
    max(wmax - wmin, 1e-8) / 15, zero = clamp(round(-wmin / scale), 0, 15);
  * KV: per token and head, asymmetric, scale = max(max - min, 1e-8) /
    (2^bits - 1), zero = min; the cache stores scale and zero in bf16 when
    2 * kv_heads is a multiple of 16 (the program's layout rule).
"""

from __future__ import annotations

import torch


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once (a CUDA division by a Python scalar multiplies by
    its reciprocal instead)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def fake_quant_act(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x [..., K] f32 -> its per-token symmetric `bits`-bit value, dequantized."""
    qmax = float((1 << (bits - 1)) - 1)
    scale = _div(torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8), qmax)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q * scale


def dequant_w4_per_channel(w: torch.Tensor) -> torch.Tensor:
    """A float [K, N] weight -> its per-channel W4 value, dequantized (f32)."""
    w = w.to(torch.float32)
    wmin, wmax = w.amin(dim=0), w.amax(dim=0)
    scale = _div(torch.clamp(wmax - wmin, min=1e-8), 15.0)
    zero = torch.clamp(torch.round(-wmin / scale), 0, 15)
    q = torch.clamp(torch.round(w / scale) + zero, 0, 15)
    return q * scale[None, :] - (scale * zero)[None, :]


def fake_quant_kv(x: torch.Tensor, bits: int, scale_dtype) -> torch.Tensor:
    """x [..., D] f32 -> its asymmetric `bits`-bit cache value, dequantized
    with the scale and zero as the cache stores them (scale_dtype)."""
    qmax = float((1 << bits) - 1)
    mx = x.amax(dim=-1, keepdim=True)
    mn = x.amin(dim=-1, keepdim=True)
    scale = _div(torch.clamp(mx - mn, min=1e-8), qmax)
    q = torch.clamp(torch.round((x - mn) / scale), 0, qmax)
    return q * scale.to(scale_dtype).float() + mn.to(scale_dtype).float()


def kv_scale_dtype(kv_heads: int) -> torch.dtype:
    return torch.bfloat16 if (2 * kv_heads) % 16 == 0 else torch.float32
