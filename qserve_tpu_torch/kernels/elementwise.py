"""K1: the fused elementwise/quant ops as one Triton kernel.

Replaces: qserve_tpu/kernels/pallas_elementwise.py _add_rmsnorm_quant_jit,
_quant_jit, _silu_mul_quant_jit and _rmsnorm_quant_jit.

Each op is one pass over a token row: read it, reduce (mean square, amax),
scale, round, write int8 codes, the per-token scale and the act-sum. What
bounds it on an H100 is the bytes of that pass (3.35 TB/s); nothing in it
needs a tensor core, and the row reduction is what Triton's block model
expresses directly. One program owns one row, whole in registers (rows are
at most 16384 wide on the path), so every input byte is read once.

The kernel lives in elementwise_triton.py and is imported on first launch:
the CPU tests import this module without triton.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from qserve_tpu_torch.kernels import _build
from qserve_tpu_torch.utils.utils import next_power_of_2

NAME = "elementwise"

MODE_QUANT = 0
MODE_RMSNORM = 1
MODE_ADD_RMSNORM = 2
MODE_SILU_MUL = 3


def _check(t: torch.Tensor, dtype, what: str, ndim: int = 2) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-d tensor, got {tuple(t.shape)}")


def launch(
    mode: int,
    x: torch.Tensor,
    delta: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (h_new | None, q int8 [T, W], scale f32 [T, 1], asum f32 [T, 1])."""
    _check(x, torch.bfloat16, "x")
    T = x.shape[0]
    W = x.shape[1] // 2 if mode == MODE_SILU_MUL else x.shape[1]
    if mode == MODE_SILU_MUL and x.shape[1] != 2 * W:
        raise ValueError("silu_mul_quant needs an even width [g | u]")
    h_new = None
    if mode == MODE_ADD_RMSNORM:
        _check(delta, torch.bfloat16, "delta")
        if delta.shape != x.shape:
            raise ValueError("h and delta shapes differ")
        h_new = torch.empty_like(x)
    if mode in (MODE_RMSNORM, MODE_ADD_RMSNORM):
        _check(weight, torch.float32, "weight", ndim=1)
        if weight.shape[0] != W:
            raise ValueError("norm weight width differs from x")
    q = torch.empty((T, W), dtype=torch.int8, device=x.device)
    scale = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    asum = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    if T == 0:
        return h_new, q, scale, asum
    from qserve_tpu_torch.kernels import elementwise_triton as et

    block = next_power_of_2(W)
    warps = 4 if block <= 1024 else (8 if block <= 4096 else 16)
    et.fused_quant_kernel[(T,)](
        x, delta if delta is not None else x,
        weight if weight is not None else x,
        h_new if h_new is not None else x,
        q, scale, asum, W, float(eps),
        MODE=mode, BLOCK=block, num_warps=warps,
    )
    _build.count_launch(NAME)
    return h_new, q, scale, asum
