"""K6: wrapper of the chunked-prefill (prefix) attention kernel
(csrc/prefix_attention.cu).

Replaces qserve_tpu/kernels/pallas_prefix_attention.py
prefix_prefill_attention_pallas. Takes one layer of the stacked cache
(`data[li]`, `scales[li]`: views, no copy), scales in bf16 or f32, and
`prefix_len` as a host integer: it crosses as a scalar argument. The cache
mode is read off the width of a data row: H*D/2 bytes is KV4, H*D bytes is
KV8.
"""

from __future__ import annotations

import torch

from qserve_tpu_torch.kernels import _build

HEAD_DIMS = (64, 96, 128, 256)
NAME = "prefix_prefill_attention"
_ARGS = (
    [_build.P] * 7 + [_build.I] + [_build.P] * 2 + [_build.I] * 7
    + [_build.F, _build.I, _build.P]
)


def prefix_prefill_attention(
    q: torch.Tensor,  # bf16 [T, Hq, D]
    k: torch.Tensor,  # bf16 [T, H, D]
    v: torch.Tensor,  # bf16 [T, H, D]
    segment_ids: torch.Tensor,  # int32 [T], 0 = padding
    positions: torch.Tensor,  # int32 [T], absolute positions
    data: torch.Tensor,  # int8 [P, 2, ps, H*Dc], one layer
    scales: torch.Tensor,  # bf16/f32 [P, 2, 2H, ps], one layer
    block_table: torch.Tensor,  # int32 [maxP], the sequence's pages
    prefix_len: int,
    sm_scale: float,
    window: int = 0,
) -> torch.Tensor:
    T, Hq, D = q.shape
    P, _, ps, hdc = data.shape
    H = scales.shape[2] // 2
    maxP = block_table.shape[0]
    _build.check_operands((
        (q, torch.bfloat16, (T, Hq, D), "q"),
        (k, torch.bfloat16, (T, H, D), "k"),
        (v, torch.bfloat16, (T, H, D), "v"),
        (segment_ids, torch.int32, (T,), "segment_ids"),
        (positions, torch.int32, (T,), "positions"),
        (data, torch.int8, (P, 2, ps, hdc), "data"),
        (scales, scales.dtype, (P, 2, 2 * H, ps), "scales"),
        (block_table, torch.int32, (maxP,), "block_table"),
    ))
    if scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scales must be bf16 or f32, got {scales.dtype}")
    kv_bits = {H * D // 2: 4, H * D: 8}.get(hdc)
    if kv_bits is None or D not in HEAD_DIMS or Hq % H or Hq // H > 8:
        raise ValueError(f"prefix prefill needs KV4 or KV8 rows, D in {HEAD_DIMS}, "
                         f"Hq/H <= 8 (D={D}, Hq={Hq}, H={H}, row bytes={hdc})")
    prefix_len = int(prefix_len)
    if not 0 <= prefix_len <= maxP * ps:
        raise ValueError(f"prefix_len {prefix_len} outside the block table "
                         f"({maxP} pages of {ps})")
    out = torch.empty_like(q)
    if T == 0:
        return out
    fn = _build.function("prefix_attention", "qs_prefix_prefill_attention", _ARGS)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
        positions.data_ptr(), data.data_ptr(), scales.data_ptr(),
        int(scales.dtype == torch.bfloat16), block_table.data_ptr(),
        out.data_ptr(), T, Hq, H, D, kv_bits, ps, prefix_len, float(sm_scale),
        int(window), _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
