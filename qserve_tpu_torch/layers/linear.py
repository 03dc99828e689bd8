"""Quantized linear layers as parameter tuples + apply functions
(qserve_tpu/layers/linear.py).

Parameters are plain tensors in [K, N] layout, W4 packed with the JAX
package's global half-split (quant/packing.py). Four flavors: per-channel
W4, per-group W4, W8 and W16 (bf16). Model weights are stacked on a leading
[L] layer axis; `.layer(li)` takes one layer's views, which copy nothing.
It indexes whatever axis leads, so on a layer's MoE experts [NE, ...]
`.layer(e)` takes one expert's views.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from qserve_tpu_torch.kernels import ops
from qserve_tpu_torch.quant import packing, qoq


class QuantAct(NamedTuple):
    """Per-token quantized activation produced by the fused producer ops."""

    q: torch.Tensor  # int8 [T, K]
    scale: torch.Tensor  # f32 [T, 1]
    asum: Optional[torch.Tensor]  # f32 [T, 1] (per-channel W4 path only)


class W4ChnLinear(NamedTuple):
    qweight: torch.Tensor  # int8 [(L,) K//2, N] packed nibbles
    s1_scale: torch.Tensor  # f32 [(L,) N]
    s1_szero: torch.Tensor  # f32 [(L,) N]

    def layer(self, li: int) -> "W4ChnLinear":
        """One layer of a stacked [L, ...] weight: views, no copy."""
        return W4ChnLinear(self.qweight[li], self.s1_scale[li], self.s1_szero[li])


class W4GrpLinear(NamedTuple):
    qweight: torch.Tensor  # int8 [(L,) K//2, N] packed nibbles
    s2_scale: torch.Tensor  # int8 (uint8 values) [(L,) K//G, N]
    s2_zero: torch.Tensor  # int8 [(L,) K//G, N]
    s1_scale: torch.Tensor  # f32 [(L,) N]

    def layer(self, li: int) -> "W4GrpLinear":
        return W4GrpLinear(*(x[li] for x in self))


class W8Linear(NamedTuple):
    qweight: torch.Tensor  # int8 [(L,) K, N]
    scale: torch.Tensor  # f32 [(L,) N]

    def layer(self, li: int) -> "W8Linear":
        return W8Linear(self.qweight[li], self.scale[li])


class W16Linear(NamedTuple):
    weight: torch.Tensor  # bf16 [(L,) K, N]

    def layer(self, li: int) -> "W16Linear":
        return W16Linear(self.weight[li])


LinearParams = Union[W4ChnLinear, W4GrpLinear, W8Linear, W16Linear]


def needs_act_sum(p: LinearParams) -> bool:
    return isinstance(p, W4ChnLinear)


def apply_linear(
    p: LinearParams,
    x: Union[QuantAct, torch.Tensor],
    group_size: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """One layer's weight [K, N] applied to [T, K] activations -> out_dtype
    [T, N]: a QuantAct for the quantized flavors, a bf16 tensor for W16."""
    if isinstance(p, W16Linear):
        if not isinstance(x, torch.Tensor):
            raise TypeError("the W16 path takes float activations")
        return ops.matmul(x, p.weight, out_dtype)
    if not isinstance(x, QuantAct):
        raise TypeError("the quantized path takes a QuantAct")
    if isinstance(p, W4ChnLinear):
        if x.asum is None:
            raise ValueError("per-channel W4 needs the act-sum")
        if out_dtype != torch.bfloat16:
            raise ValueError("the per-channel W4 GEMM writes bf16 only")
        return ops.w4a8_gemm_per_chn(
            x.q, x.scale, x.asum, p.qweight, p.s1_scale, p.s1_szero
        )
    if isinstance(p, W4GrpLinear):
        return ops.w4a8_gemm_per_group(
            x.q, x.scale, p.qweight, p.s2_scale, p.s2_zero, p.s1_scale,
            group_size, out_dtype,
        )
    if isinstance(p, W8Linear):
        return ops.w8a8_gemm(x.q, x.scale, p.qweight, p.scale, out_dtype)
    raise TypeError(f"unknown linear params {type(p)}")


def supports_routed(p: LinearParams) -> bool:
    """Can apply_linear_routed run this flavor? (All current flavors.)"""
    return isinstance(p, (W4ChnLinear, W4GrpLinear, W8Linear, W16Linear))


def apply_linear_routed(
    p: LinearParams,
    x: Union[QuantAct, torch.Tensor],
    block_expert: torch.Tensor,  # int32 [nb]: the expert of each M block
    group_size: int = 128,
) -> torch.Tensor:
    """Grouped MoE expert product over a token stream [M, K] sorted by
    expert and padded: each M / nb-row block multiplies ONE expert's weights
    of the layer's [NE, K, N] experts -> bf16 [M, N]."""
    if isinstance(p, W16Linear):
        if not isinstance(x, torch.Tensor):
            raise TypeError("the W16 path takes float activations")
        return ops.matmul_routed(x, p.weight, block_expert)
    if not isinstance(x, QuantAct):
        raise TypeError("the quantized path takes a QuantAct")
    if isinstance(p, W4ChnLinear):
        if x.asum is None:
            raise ValueError("per-channel W4 needs the act-sum")
        return ops.w4a8_gemm_per_chn_routed(
            x.q, x.scale, x.asum, p.qweight, p.s1_scale, p.s1_szero, block_expert
        )
    if isinstance(p, W4GrpLinear):
        return ops.w4a8_gemm_per_group_routed(
            x.q, x.scale, p.qweight, p.s2_scale, p.s2_zero, p.s1_scale,
            block_expert, group_size,
        )
    if isinstance(p, W8Linear):
        return ops.w8a8_gemm_routed(x.q, x.scale, p.qweight, p.scale, block_expert)
    raise TypeError(f"no routed path for {type(p)}")


def quantize_linear_from_float(
    w: torch.Tensor, weight_bits: int, group_size: int = -1
) -> LinearParams:
    """Quantize a float [K, N] weight into the packed serving format."""
    if weight_bits == 16:
        return W16Linear(weight=w.to(torch.bfloat16))
    if weight_bits == 8:
        p = qoq.quantize_weight_w8(w)
        return W8Linear(qweight=p.qweight, scale=p.scale)
    if weight_bits == 4:
        if group_size == -1:
            p = qoq.quantize_weight_per_channel(w)
            return W4ChnLinear(
                qweight=packing.pack_w4(p.qweight),
                s1_scale=p.s1_scale,
                s1_szero=p.s1_szero,
            )
        p = qoq.quantize_weight_per_group(w, group_size)
        return W4GrpLinear(
            qweight=packing.pack_w4(p.qweight),
            s2_scale=p.s2_scale,
            s2_zero=p.s2_zero,
            s1_scale=p.s1_scale,
        )
    raise ValueError(f"weight_bits={weight_bits}")


def dequantize_linear(p: LinearParams, group_size: int = 128) -> torch.Tensor:
    """Float reconstruction [K, N] of one layer's weight (for tests)."""
    if isinstance(p, W16Linear):
        return p.weight.to(torch.float32)
    if isinstance(p, W8Linear):
        return qoq.dequantize_w8(qoq.W8(p.qweight, p.scale))
    q = packing.unpack_w4(p.qweight)
    if isinstance(p, W4ChnLinear):
        return qoq.dequantize_per_channel(
            qoq.PerChannelW4(q, p.s1_scale, p.s1_szero)
        )
    if isinstance(p, W4GrpLinear):
        return qoq.dequantize_per_group(
            qoq.PerGroupW4(q, p.s2_scale, p.s2_zero, p.s1_scale), group_size
        )
    raise TypeError(type(p))
