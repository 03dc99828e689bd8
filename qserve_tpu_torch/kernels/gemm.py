"""K2: wrapper of the W4A8 per-channel GEMM kernel (csrc/w4a8_gemm.cu).

Replaces qserve_tpu/kernels/pallas_gemm.py w4a8_gemm_per_chn_pallas and
w4a8_gemm_per_chn_bigm_pallas. A stacked [L, K/2, N] weight is passed as
its layer view (`qweight[li]`, no copy), so the kernel takes no index.
"""

from __future__ import annotations

import torch

from qserve_tpu_torch.kernels import _build

NAME = "w4a8_gemm_per_chn"
_ARGS = [_build.P] * 7 + [_build.I] * 3 + [_build.P]


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
    for t, dt, shape, what in (
        (a_i8, torch.int8, (M, K), "a_i8"),
        (a_scale, torch.float32, (M, 1), "a_scale"),
        (a_sum, torch.float32, (M, 1), "a_sum"),
        (qweight, torch.int8, (K // 2, N), "qweight"),
        (s1_scale, torch.float32, (N,), "s1_scale"),
        (s1_szero, torch.float32, (N,), "s1_szero"),
    ):
        if not t.is_cuda or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: want CUDA {dt} {shape}, got {t.device} {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
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
