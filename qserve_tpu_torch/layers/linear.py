"""Quantized linear layers as parameter tuples + apply functions
(qserve_tpu/layers/linear.py).

Parameters are plain tensors in [K, N] layout, W4 packed with the JAX
package's global half-split (quant/packing.py). This slice serves the
per-channel W4A8 path; the per-group, W8 and W16 flavors wait for their
kernels (ROADMAP queue 1, remaining precisions).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


LinearParams = W4ChnLinear


def needs_act_sum(p: LinearParams) -> bool:
    return isinstance(p, W4ChnLinear)


def _unported(what) -> NotImplementedError:
    return NotImplementedError(
        f"{what} linear layers are not ported yet (ROADMAP queue 1, remaining "
        "precisions: per-group, W8A8, W16A16)"
    )


def apply_linear(p: LinearParams, x: QuantAct) -> torch.Tensor:
    """QuantAct [T, K] x one layer's W4 weight [K/2, N] -> bf16 [T, N]."""
    if not isinstance(p, W4ChnLinear):
        raise _unported(type(p).__name__)
    if x.asum is None:
        raise ValueError("per-channel W4 needs the act-sum")
    return ops.w4a8_gemm_per_chn(
        x.q, x.scale, x.asum, p.qweight, p.s1_scale, p.s1_szero
    )


def quantize_linear_from_float(
    w: torch.Tensor, weight_bits: int, group_size: int = -1
) -> LinearParams:
    """Quantize a float [K, N] weight into the packed serving format."""
    if weight_bits != 4 or group_size != -1:
        raise _unported(f"w{weight_bits} group {group_size}")
    p = qoq.quantize_weight_per_channel(w)
    return W4ChnLinear(
        qweight=packing.pack_w4(p.qweight),
        s1_scale=p.s1_scale,
        s1_szero=p.s1_szero,
    )
