"""Public compute ops of the port (qserve_tpu/kernels/ops.py).

Each op dispatches on the device of its input alone: a CUDA tensor launches
the op's hand-written kernel, a CPU tensor takes the plain PyTorch version
defined next to it. There is no switch and no fallback: a kernel that cannot
take its input raises. The plain versions are the oracles the kernels are
held against on the card.

rmsnorm (the final norm, the W16A16 layers and the MoE block's norm),
silu_mul and matmul (the bf16 lm_head, the W16A16 linears and the MoE
router) and matmul_routed (the W16A16 experts) were XLA in the JAX package,
not Pallas; they are plain PyTorch on every device.

The routed GEMMs serve the MoE dispatch of long token streams: tokens come
sorted by expert and padded so that each of the nb blocks of M / nb rows
belongs to one expert, `block_expert` int32 [nb] names it, and the weights
are one layer's [NE, ...] experts (the JAX package took a [nb, d] index
into the whole stacked model instead).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from qserve_tpu_torch.quant import packing, qoq

QuantOut = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _rms(xf: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * weight.to(torch.float32)


# --- per-token INT8 quantization ---------------------------------------


def quant_per_token_plain(x: torch.Tensor, with_sum: bool = False) -> QuantOut:
    return qoq.quantize_activation_per_token(x, with_sum)


def quant_per_token(x: torch.Tensor, with_sum: bool = False) -> QuantOut:
    """fp [T, K] -> (int8 [T, K], scale f32 [T, 1], act-sum f32 [T, 1] | None)."""
    if x.is_cuda:
        from qserve_tpu_torch.kernels import elementwise as ew

        _, q, s, asum = ew.launch(ew.MODE_QUANT, x)
        return q, s, (asum if with_sum else None)
    return quant_per_token_plain(x, with_sum)


# --- RMSNorm (+ residual add) fused with INT8 quantization -------------


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _rms(x.to(torch.float32), weight, eps).to(x.dtype)


def rmsnorm_quant_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, with_sum: bool = False
) -> QuantOut:
    return qoq.quantize_activation_per_token(_rms(x.to(torch.float32), weight, eps), with_sum)


def rmsnorm_quant(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, with_sum: bool = False
) -> QuantOut:
    if x.is_cuda:
        from qserve_tpu_torch.kernels import elementwise as ew

        _, q, s, asum = ew.launch(ew.MODE_RMSNORM, x, weight=weight, eps=eps)
        return q, s, (asum if with_sum else None)
    return rmsnorm_quant_plain(x, weight, eps, with_sum)


def add_rmsnorm_quant_plain(
    h: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-6, with_sum: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    h_new = (h.to(torch.float32) + delta.to(torch.float32)).to(h.dtype)
    q, s, asum = rmsnorm_quant_plain(h_new, weight, eps, with_sum)
    return h_new, q, s, asum


def add_rmsnorm_quant(
    h: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
    eps: float = 1e-6, with_sum: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Residual add + RMSNorm of the ROUNDED sum + per-token INT8 quant.
    Returns (h_new = h + delta in h.dtype, q, scale, asum | None)."""
    if h.is_cuda:
        from qserve_tpu_torch.kernels import elementwise as ew

        h_new, q, s, asum = ew.launch(
            ew.MODE_ADD_RMSNORM, h, delta=delta, weight=weight, eps=eps
        )
        return h_new, q, s, (asum if with_sum else None)
    return add_rmsnorm_quant_plain(h, delta, weight, eps, with_sum)


# --- SwiGLU fused with INT8 quantization -------------------------------


def silu_mul(gate_up: torch.Tensor) -> torch.Tensor:
    g, u = gate_up.to(torch.float32).chunk(2, dim=-1)
    return (F.silu(g) * u).to(gate_up.dtype)


def silu_mul_quant_plain(gate_up: torch.Tensor, with_sum: bool = False) -> QuantOut:
    g, u = gate_up.to(torch.float32).chunk(2, dim=-1)
    return qoq.quantize_activation_per_token(F.silu(g) * u, with_sum)


def silu_mul_quant(gate_up: torch.Tensor, with_sum: bool = False) -> QuantOut:
    """[T, 2I] (gate ++ up) -> silu(gate) * up, quantized per token."""
    if gate_up.is_cuda:
        from qserve_tpu_torch.kernels import elementwise as ew

        _, q, s, asum = ew.launch(ew.MODE_SILU_MUL, gate_up)
        return q, s, (asum if with_sum else None)
    return silu_mul_quant_plain(gate_up, with_sum)


# --- W4A8 per-channel GEMM ----------------------------------------------


def w4a8_gemm_per_chn_plain(
    a_i8: torch.Tensor, a_scale: torch.Tensor, a_sum: torch.Tensor,
    qweight_packed: torch.Tensor, s1_scale: torch.Tensor, s1_szero: torch.Tensor,
) -> torch.Tensor:
    p = qoq.PerChannelW4(packing.unpack_w4(qweight_packed), s1_scale, s1_szero)
    return qoq.w4a8_gemm_per_channel_ref(a_i8, a_scale, a_sum, p)


def w4a8_gemm_per_chn(
    a_i8: torch.Tensor, a_scale: torch.Tensor, a_sum: torch.Tensor,
    qweight_packed: torch.Tensor, s1_scale: torch.Tensor, s1_szero: torch.Tensor,
) -> torch.Tensor:
    """int8 [M, K] x packed UINT4 [K/2, N] -> bf16 [M, N]. Stacked weights
    are passed as their layer view (`qweight[li]`)."""
    if a_i8.is_cuda:
        from qserve_tpu_torch.kernels.gemm import w4a8_gemm_per_chn as kernel

        return kernel(a_i8, a_scale, a_sum, qweight_packed, s1_scale, s1_szero)
    return w4a8_gemm_per_chn_plain(
        a_i8, a_scale, a_sum, qweight_packed, s1_scale, s1_szero
    )


# --- W4A8 per-group GEMM -------------------------------------------------


def w4a8_gemm_per_group_plain(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight_packed: torch.Tensor,
    s2_scale: torch.Tensor, s2_zero: torch.Tensor, s1_scale: torch.Tensor,
    group_size: int = 128, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    p = qoq.PerGroupW4(
        packing.unpack_w4(qweight_packed), s2_scale, s2_zero, s1_scale
    )
    return qoq.w4a8_gemm_per_group_ref(a_i8, a_scale, p, group_size, out_dtype)


def w4a8_gemm_per_group(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight_packed: torch.Tensor,
    s2_scale: torch.Tensor, s2_zero: torch.Tensor, s1_scale: torch.Tensor,
    group_size: int = 128, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """int8 [M, K] x packed UINT4 [K/2, N] with per-group integer scale and
    zero [K/G, N] -> out_dtype [M, N] (bf16 or f32)."""
    if a_i8.is_cuda:
        from qserve_tpu_torch.kernels.gemm import w4a8_gemm_per_group as kernel

        return kernel(a_i8, a_scale, qweight_packed, s2_scale, s2_zero,
                      s1_scale, group_size, out_dtype)
    return w4a8_gemm_per_group_plain(
        a_i8, a_scale, qweight_packed, s2_scale, s2_zero, s1_scale,
        group_size, out_dtype,
    )


# --- W8A8 GEMM -----------------------------------------------------------


def w8a8_gemm_plain(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight: torch.Tensor,
    w_scale: torch.Tensor, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    return qoq.w8a8_gemm_ref(a_i8, a_scale, qoq.W8(qweight, w_scale), out_dtype)


def w8a8_gemm(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight: torch.Tensor,
    w_scale: torch.Tensor, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> out_dtype [M, N] (bf16 or f32)."""
    if a_i8.is_cuda:
        from qserve_tpu_torch.kernels.gemm import w8a8_gemm as kernel

        return kernel(a_i8, a_scale, qweight, w_scale, out_dtype)
    return w8a8_gemm_plain(a_i8, a_scale, qweight, w_scale, out_dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """bf16 [M, K] x bf16 [K, N] with fp32 accumulation and fp32 result,
    cast to out_dtype (the bf16 lm_head and the W16A16 linears; XLA in the
    JAX package, a library product here)."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32).to(out_dtype)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(out_dtype)


# --- routed (grouped) MoE GEMMs -------------------------------------------


def _expert_runs(block_expert: torch.Tensor, M: int):
    """(expert, first row, end row) of each run of consecutive blocks with
    one expert (the plain versions read block_expert on the host)."""
    nb = block_expert.shape[0]
    bm = M // nb
    runs = []
    for b, e in enumerate(block_expert.tolist()):
        if runs and runs[-1][0] == e:
            runs[-1][2] += bm
        else:
            runs.append([e, b * bm, (b + 1) * bm])
    return runs


def _routed_plain(M: int, block_expert, gemm_of_expert) -> torch.Tensor:
    """Each run of blocks through the dense plain GEMM of its expert: the
    same integer sums (exact) and the same f32 epilogue, row by row."""
    return torch.cat([gemm_of_expert(e, slice(r0, r1))
                      for e, r0, r1 in _expert_runs(block_expert, M)])


def w4a8_gemm_per_chn_routed_plain(
    a_i8: torch.Tensor, a_scale: torch.Tensor, a_sum: torch.Tensor,
    qweight_packed: torch.Tensor, s1_scale: torch.Tensor, s1_szero: torch.Tensor,
    block_expert: torch.Tensor,
) -> torch.Tensor:
    return _routed_plain(
        a_i8.shape[0], block_expert,
        lambda e, r: w4a8_gemm_per_chn_plain(
            a_i8[r], a_scale[r], a_sum[r], qweight_packed[e], s1_scale[e],
            s1_szero[e]),
    )


def w4a8_gemm_per_chn_routed(
    a_i8: torch.Tensor, a_scale: torch.Tensor, a_sum: torch.Tensor,
    qweight_packed: torch.Tensor, s1_scale: torch.Tensor, s1_szero: torch.Tensor,
    block_expert: torch.Tensor,
) -> torch.Tensor:
    """int8 [M, K] x packed UINT4 [NE, K/2, N] -> bf16 [M, N], each M block
    by its own expert's weights."""
    if a_i8.is_cuda:
        from qserve_tpu_torch.kernels.gemm import w4a8_gemm_per_chn_routed as kernel

        return kernel(a_i8, a_scale, a_sum, qweight_packed, s1_scale, s1_szero,
                      block_expert)
    return w4a8_gemm_per_chn_routed_plain(
        a_i8, a_scale, a_sum, qweight_packed, s1_scale, s1_szero, block_expert
    )


def w4a8_gemm_per_group_routed_plain(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight_packed: torch.Tensor,
    s2_scale: torch.Tensor, s2_zero: torch.Tensor, s1_scale: torch.Tensor,
    block_expert: torch.Tensor, group_size: int = 128,
) -> torch.Tensor:
    return _routed_plain(
        a_i8.shape[0], block_expert,
        lambda e, r: w4a8_gemm_per_group_plain(
            a_i8[r], a_scale[r], qweight_packed[e], s2_scale[e], s2_zero[e],
            s1_scale[e], group_size),
    )


def w4a8_gemm_per_group_routed(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight_packed: torch.Tensor,
    s2_scale: torch.Tensor, s2_zero: torch.Tensor, s1_scale: torch.Tensor,
    block_expert: torch.Tensor, group_size: int = 128,
) -> torch.Tensor:
    """int8 [M, K] x per-group W4 [NE, ...] -> bf16 [M, N], each M block by
    its own expert's weights; any group count, tiled or ragged."""
    if a_i8.is_cuda:
        from qserve_tpu_torch.kernels.gemm import w4a8_gemm_per_group_routed as kernel

        return kernel(a_i8, a_scale, qweight_packed, s2_scale, s2_zero, s1_scale,
                      block_expert, group_size)
    return w4a8_gemm_per_group_routed_plain(
        a_i8, a_scale, qweight_packed, s2_scale, s2_zero, s1_scale,
        block_expert, group_size,
    )


def w8a8_gemm_routed_plain(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight: torch.Tensor,
    w_scale: torch.Tensor, block_expert: torch.Tensor,
) -> torch.Tensor:
    return _routed_plain(
        a_i8.shape[0], block_expert,
        lambda e, r: w8a8_gemm_plain(a_i8[r], a_scale[r], qweight[e], w_scale[e]),
    )


def w8a8_gemm_routed(
    a_i8: torch.Tensor, a_scale: torch.Tensor, qweight: torch.Tensor,
    w_scale: torch.Tensor, block_expert: torch.Tensor,
) -> torch.Tensor:
    """int8 [M, K] x int8 [NE, K, N] -> bf16 [M, N], each M block by its own
    expert's weights."""
    if a_i8.is_cuda:
        from qserve_tpu_torch.kernels.gemm import w8a8_gemm_routed as kernel

        return kernel(a_i8, a_scale, qweight, w_scale, block_expert)
    return w8a8_gemm_routed_plain(a_i8, a_scale, qweight, w_scale, block_expert)


def matmul_routed(
    x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """bf16 [M, K] x bf16 [NE, K, N] -> out_dtype [M, N], each M block by its
    own expert's weights: a per-block weight gather and a batched product
    in f32 (the W16A16 experts; XLA in the JAX package)."""
    nb = block_expert.shape[0]
    M, K = x.shape
    wb = w[block_expert.long()].to(torch.float32)  # [nb, K, N]
    out = torch.bmm(x.reshape(nb, M // nb, K).to(torch.float32), wb)
    return out.reshape(M, -1).to(out_dtype)
