"""K2, K8, K9: wrappers of the quantized GEMM kernels (csrc/w4a8_gemm.cu,
csrc/w4a8_gemm_per_group.cu, csrc/w8a8_gemm.cu; one wgmma main loop on
128x128 tiles in csrc/gemm_common.cuh), and of their routed MoE forms (a
second entry point in each source).

Replace qserve_tpu/kernels/pallas_gemm.py w4a8_gemm_per_chn_pallas and
w4a8_gemm_per_chn_bigm_pallas (K2), w4a8_gemm_per_group_pallas and
w4a8_gemm_per_group_whole_pallas (K8) and w8a8_gemm_pallas (K9); the routed
forms replace w4a8_gemm_per_chn_routed_pallas, w4a8_gemm_per_group_routed_pallas
with w4a8_gemm_per_group_whole_routed_pallas, and w8a8_gemm_routed_pallas.
A stacked [L, ...] weight is passed as its layer view (`qweight[li]`, no
copy), so the kernels take no layer index. The routed forms take the
layer's [NE, ...] expert weights and `block_expert` int32 [nb], the expert
of each M / nb-row block of the sorted, padded token stream.
"""

from __future__ import annotations

import torch

from qserve_tpu_torch.kernels import _build

NAME = "w4a8_gemm_per_chn"
NAME_GROUP = "w4a8_gemm_per_group"
NAME_W8 = "w8a8_gemm"
NAME_ROUTED = "w4a8_gemm_per_chn_routed"
NAME_GROUP_ROUTED = "w4a8_gemm_per_group_routed"
NAME_W8_ROUTED = "w8a8_gemm_routed"
_ARGS = [_build.P] * 7 + [_build.I] * 3 + [_build.P]
_ARGS_GROUP = [_build.P] * 7 + [_build.I] * 5 + [_build.P]
_ARGS_W8 = [_build.P] * 5 + [_build.I] * 4 + [_build.P]
_ARGS_ROUTED = [_build.P] * 8 + [_build.I] * 4 + [_build.P]
_ARGS_GROUP_ROUTED = [_build.P] * 8 + [_build.I] * 5 + [_build.P]
_ARGS_W8_ROUTED = [_build.P] * 6 + [_build.I] * 4 + [_build.P]


def _out_f32(name: str, out_dtype) -> int:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} writes bf16 or f32, not {out_dtype}")
    return int(out_dtype == torch.float32)


def w4a8_gemm_per_chn(
    a_i8: torch.Tensor,  # int8 [M, K]
    a_scale: torch.Tensor,  # f32 [M, 1]
    a_sum: torch.Tensor,  # f32 [M, 1]
    qweight: torch.Tensor,  # int8 [K/2, N], half-split nibbles
    s1_scale: torch.Tensor,  # f32 [N]
    s1_szero: torch.Tensor,  # f32 [N]
) -> torch.Tensor:
    """bf16 [M, N] = (A.Wq * s1) * a_scale - s1_szero * a_sum."""
    M, K = a_i8.shape
    K2, N = qweight.shape
    _build.check_operands((
        (a_i8, torch.int8, (M, K), "a_i8"),
        (a_scale, torch.float32, (M, 1), "a_scale"),
        (a_sum, torch.float32, (M, 1), "a_sum"),
        (qweight, torch.int8, (K // 2, N), "qweight"),
        (s1_scale, torch.float32, (N,), "s1_scale"),
        (s1_szero, torch.float32, (N,), "s1_szero"),
    ))
    if K % 64 or N % 64 or K2 * 2 != K:
        raise ValueError(f"w4a8_gemm_per_chn needs K, N % 64 == 0 (K={K}, N={N})")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a_i8.device)
    if M == 0:
        return out
    fn = _build.function("w4a8_gemm", "qs_w4a8_gemm_per_chn", _ARGS)
    rc = fn(
        a_i8.data_ptr(), qweight.data_ptr(), s1_scale.data_ptr(),
        s1_szero.data_ptr(), a_scale.data_ptr(), a_sum.data_ptr(),
        out.data_ptr(), M, N, K, _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out


def w4a8_gemm_per_group(
    a_i8: torch.Tensor,  # int8 [M, K]
    a_scale: torch.Tensor,  # f32 [M, 1]
    qweight: torch.Tensor,  # int8 [K/2, N], half-split nibbles
    s2_scale: torch.Tensor,  # int8 [K/G, N], uint8 values
    s2_zero: torch.Tensor,  # int8 [K/G, N]
    s1_scale: torch.Tensor,  # f32 [N]
    group_size: int = 128,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """[M, N] = (A.(Wq * s2 + z2)) * s1 * a_scale, in bf16 or f32."""
    M, K = a_i8.shape
    K2, N = qweight.shape
    G = int(group_size)
    # 32 packed rows a step: a step must not straddle a group of either
    # nibble plane (a group may straddle the planes)
    if G <= 0 or G % 32 or K % 64 or N % 64 or K2 * 2 != K or K % G:
        raise ValueError(
            f"w4a8_gemm_per_group needs K, N % 64 == 0, group_size % 32 == 0 "
            f"and K % group_size == 0 (K={K}, N={N}, group_size={G})"
        )
    _build.check_operands((
        (a_i8, torch.int8, (M, K), "a_i8"),
        (a_scale, torch.float32, (M, 1), "a_scale"),
        (qweight, torch.int8, (K // 2, N), "qweight"),
        (s2_scale, torch.int8, (K // G, N), "s2_scale"),
        (s2_zero, torch.int8, (K // G, N), "s2_zero"),
        (s1_scale, torch.float32, (N,), "s1_scale"),
    ))
    f32 = _out_f32(NAME_GROUP, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=a_i8.device)
    if M == 0:
        return out
    fn = _build.function(
        "w4a8_gemm_per_group", "qs_w4a8_gemm_per_group", _ARGS_GROUP
    )
    rc = fn(
        a_i8.data_ptr(), qweight.data_ptr(), s2_scale.data_ptr(),
        s2_zero.data_ptr(), s1_scale.data_ptr(), a_scale.data_ptr(),
        out.data_ptr(), f32, M, N, K, G, _build.stream(),
    )
    _build.check(NAME_GROUP, rc)
    _build.count_launch(NAME_GROUP)
    return out


def w8a8_gemm(
    a_i8: torch.Tensor,  # int8 [M, K]
    a_scale: torch.Tensor,  # f32 [M, 1]
    qweight: torch.Tensor,  # int8 [K, N]
    w_scale: torch.Tensor,  # f32 [N]
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """[M, N] = (A.W) * w_scale * a_scale, in bf16 or f32."""
    M, K = a_i8.shape
    N = qweight.shape[1]
    if K % 64 or N % 64:
        raise ValueError(f"w8a8_gemm needs K, N % 64 == 0 (K={K}, N={N})")
    _build.check_operands((
        (a_i8, torch.int8, (M, K), "a_i8"),
        (a_scale, torch.float32, (M, 1), "a_scale"),
        (qweight, torch.int8, (K, N), "qweight"),
        (w_scale, torch.float32, (N,), "w_scale"),
    ))
    f32 = _out_f32(NAME_W8, out_dtype)
    out = torch.empty((M, N), dtype=out_dtype, device=a_i8.device)
    if M == 0:
        return out
    fn = _build.function("w8a8_gemm", "qs_w8a8_gemm", _ARGS_W8)
    rc = fn(
        a_i8.data_ptr(), qweight.data_ptr(), w_scale.data_ptr(),
        a_scale.data_ptr(), out.data_ptr(), f32, M, N, K, _build.stream(),
    )
    _build.check(NAME_W8, rc)
    _build.count_launch(NAME_W8)
    return out


def _route_rows(name: str, M: int, block_expert: torch.Tensor) -> int:
    """Rows of one routed block: M / nb, a multiple of the kernels' 128-row
    tile (the wgmma loop's) so that no tile straddles two experts."""
    nb = block_expert.shape[0] if block_expert.dim() == 1 else 0
    if nb == 0 or M % nb or (M // nb) % 128:
        raise ValueError(
            f"{name} needs block_expert [nb] with M % nb == 0 and "
            f"(M / nb) % 128 == 0 (M={M}, block_expert {tuple(block_expert.shape)})"
        )
    return M // nb


def w4a8_gemm_per_chn_routed(
    a_i8: torch.Tensor,  # int8 [M, K], sorted by expert and padded
    a_scale: torch.Tensor,  # f32 [M, 1]
    a_sum: torch.Tensor,  # f32 [M, 1]
    qweight: torch.Tensor,  # int8 [NE, K/2, N], half-split nibbles
    s1_scale: torch.Tensor,  # f32 [NE, N]
    s1_szero: torch.Tensor,  # f32 [NE, N]
    block_expert: torch.Tensor,  # int32 [nb], values in [0, NE)
) -> torch.Tensor:
    """bf16 [M, N]; rows of block b use expert block_expert[b]."""
    M, K = a_i8.shape
    NE, K2, N = qweight.shape
    rows = _route_rows(NAME_ROUTED, M, block_expert)
    _build.check_operands((
        (a_i8, torch.int8, (M, K), "a_i8"),
        (a_scale, torch.float32, (M, 1), "a_scale"),
        (a_sum, torch.float32, (M, 1), "a_sum"),
        (qweight, torch.int8, (NE, K // 2, N), "qweight"),
        (s1_scale, torch.float32, (NE, N), "s1_scale"),
        (s1_szero, torch.float32, (NE, N), "s1_szero"),
        (block_expert, torch.int32, (M // rows,), "block_expert"),
    ))
    if K % 64 or N % 64 or K2 * 2 != K:
        raise ValueError(f"{NAME_ROUTED} needs K, N % 64 == 0 (K={K}, N={N})")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a_i8.device)
    fn = _build.function("w4a8_gemm", "qs_w4a8_gemm_per_chn_routed", _ARGS_ROUTED)
    rc = fn(
        a_i8.data_ptr(), qweight.data_ptr(), s1_scale.data_ptr(),
        s1_szero.data_ptr(), a_scale.data_ptr(), a_sum.data_ptr(),
        block_expert.data_ptr(), out.data_ptr(), M, N, K, rows, _build.stream(),
    )
    _build.check(NAME_ROUTED, rc)
    _build.count_launch(NAME_ROUTED)
    return out


def w4a8_gemm_per_group_routed(
    a_i8: torch.Tensor,  # int8 [M, K], sorted by expert and padded
    a_scale: torch.Tensor,  # f32 [M, 1]
    qweight: torch.Tensor,  # int8 [NE, K/2, N], half-split nibbles
    s2_scale: torch.Tensor,  # int8 [NE, K/G, N], uint8 values
    s2_zero: torch.Tensor,  # int8 [NE, K/G, N]
    s1_scale: torch.Tensor,  # f32 [NE, N]
    block_expert: torch.Tensor,  # int32 [nb], values in [0, NE)
    group_size: int = 128,
) -> torch.Tensor:
    """bf16 [M, N]; rows of block b use expert block_expert[b]. Any group
    count, tiled or ragged, as the dense kernel."""
    M, K = a_i8.shape
    NE, K2, N = qweight.shape
    G = int(group_size)
    if G <= 0 or G % 32 or K % 64 or N % 64 or K2 * 2 != K or K % G:
        raise ValueError(
            f"{NAME_GROUP_ROUTED} needs K, N % 64 == 0, group_size % 32 == 0 "
            f"and K % group_size == 0 (K={K}, N={N}, group_size={G})"
        )
    rows = _route_rows(NAME_GROUP_ROUTED, M, block_expert)
    _build.check_operands((
        (a_i8, torch.int8, (M, K), "a_i8"),
        (a_scale, torch.float32, (M, 1), "a_scale"),
        (qweight, torch.int8, (NE, K // 2, N), "qweight"),
        (s2_scale, torch.int8, (NE, K // G, N), "s2_scale"),
        (s2_zero, torch.int8, (NE, K // G, N), "s2_zero"),
        (s1_scale, torch.float32, (NE, N), "s1_scale"),
        (block_expert, torch.int32, (M // rows,), "block_expert"),
    ))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a_i8.device)
    fn = _build.function(
        "w4a8_gemm_per_group", "qs_w4a8_gemm_per_group_routed", _ARGS_GROUP_ROUTED
    )
    rc = fn(
        a_i8.data_ptr(), qweight.data_ptr(), s2_scale.data_ptr(),
        s2_zero.data_ptr(), s1_scale.data_ptr(), a_scale.data_ptr(),
        block_expert.data_ptr(), out.data_ptr(), M, N, K, G, rows,
        _build.stream(),
    )
    _build.check(NAME_GROUP_ROUTED, rc)
    _build.count_launch(NAME_GROUP_ROUTED)
    return out


def w8a8_gemm_routed(
    a_i8: torch.Tensor,  # int8 [M, K], sorted by expert and padded
    a_scale: torch.Tensor,  # f32 [M, 1]
    qweight: torch.Tensor,  # int8 [NE, K, N]
    w_scale: torch.Tensor,  # f32 [NE, N]
    block_expert: torch.Tensor,  # int32 [nb], values in [0, NE)
) -> torch.Tensor:
    """bf16 [M, N]; rows of block b use expert block_expert[b]."""
    M, K = a_i8.shape
    NE, _, N = qweight.shape
    if K % 64 or N % 64:
        raise ValueError(f"{NAME_W8_ROUTED} needs K, N % 64 == 0 (K={K}, N={N})")
    rows = _route_rows(NAME_W8_ROUTED, M, block_expert)
    _build.check_operands((
        (a_i8, torch.int8, (M, K), "a_i8"),
        (a_scale, torch.float32, (M, 1), "a_scale"),
        (qweight, torch.int8, (NE, K, N), "qweight"),
        (w_scale, torch.float32, (NE, N), "w_scale"),
        (block_expert, torch.int32, (M // rows,), "block_expert"),
    ))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a_i8.device)
    fn = _build.function("w8a8_gemm", "qs_w8a8_gemm_routed", _ARGS_W8_ROUTED)
    rc = fn(
        a_i8.data_ptr(), qweight.data_ptr(), w_scale.data_ptr(),
        a_scale.data_ptr(), block_expert.data_ptr(), out.data_ptr(),
        M, N, K, rows, _build.stream(),
    )
    _build.check(NAME_W8_ROUTED, rc)
    _build.count_launch(NAME_W8_ROUTED)
    return out
