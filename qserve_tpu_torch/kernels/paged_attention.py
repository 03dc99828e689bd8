"""K4: wrapper of the paged quantized (KV4 or KV8) decode attention kernel
(csrc/paged_attention.cu).

Replaces qserve_tpu/kernels/pallas_paged_attention.py
paged_decode_attention_pallas together with its dispatch's exact
current-token merge. Takes one layer of the stacked cache (`data[li]`,
`scales[li]`: views, no copy) and scales in bf16 or f32. The cache mode is
read off the width of a data row: H*D/2 bytes is KV4, H*D bytes is KV8.
"""

from __future__ import annotations

import torch

from qserve_tpu_torch.kernels import _build

NAME = "paged_decode_attention"
_ARGS = (
    [_build.P] * 3 + [_build.I] + [_build.P] * 5 + [_build.I] * 7
    + [_build.F, _build.I, _build.P]
)


def paged_decode_attention(
    q: torch.Tensor,  # bf16 [B, Hq, D]
    data: torch.Tensor,  # int8 [P, 2, ps, H*Dc], one layer
    scales: torch.Tensor,  # bf16/f32 [P, 2, 2H, ps], one layer
    block_tables: torch.Tensor,  # int32 [B, maxP]
    context_lens: torch.Tensor,  # int32 [B], including the current token
    k_cur: torch.Tensor,  # bf16 [B, H, D]
    v_cur: torch.Tensor,  # bf16 [B, H, D]
    sm_scale: float,
    window: int = 0,
) -> torch.Tensor:
    B, Hq, D = q.shape
    P, _, ps, hdc = data.shape
    H = scales.shape[2] // 2
    maxP = block_tables.shape[1]
    _build.check_operands((
        (q, torch.bfloat16, (B, Hq, D), "q"),
        (data, torch.int8, (P, 2, ps, hdc), "data"),
        (scales, scales.dtype, (P, 2, 2 * H, ps), "scales"),
        (block_tables, torch.int32, (B, maxP), "block_tables"),
        (context_lens, torch.int32, (B,), "context_lens"),
        (k_cur, torch.bfloat16, (B, H, D), "k_cur"),
        (v_cur, torch.bfloat16, (B, H, D), "v_cur"),
    ))
    if scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scales must be bf16 or f32, got {scales.dtype}")
    kv_bits = {H * D // 2: 4, H * D: 8}.get(hdc)
    if kv_bits is None or D not in (64, 128) or Hq % H or Hq // H > 8:
        raise ValueError(f"paged decode needs KV4 or KV8 rows, D in (64, 128), "
                         f"Hq/H <= 8 (D={D}, Hq={Hq}, H={H}, row bytes={hdc})")
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _build.function("paged_attention", "qs_paged_decode_attention", _ARGS)
    rc = fn(
        q.data_ptr(), data.data_ptr(), scales.data_ptr(),
        int(scales.dtype == torch.bfloat16),
        block_tables.data_ptr(), context_lens.data_ptr(),
        k_cur.data_ptr(), v_cur.data_ptr(), out.data_ptr(),
        B, Hq, H, D, kv_bits, ps, maxP, float(sm_scale), int(window), _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
