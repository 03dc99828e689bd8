"""K5: wrapper of the KV-cache row-scatter kernel (csrc/kv_append.cu).

Replaces qserve_tpu/kernels/pallas_kv_append.py kv_append_inplace (decode)
and kv_write_pages_inplace (prefill). Updates the cache IN PLACE (the JAX
package aliased its buffers; here the tensors are simply written).
"""

from __future__ import annotations

import torch

from qserve_tpu_torch.kernels import _build

NAME = "kv_append"
_ARGS = [_build.P] * 6 + [_build.I] * 7 + [_build.P]


def kv_append(
    data: torch.Tensor,  # int8 [L, P, 2, ps, HDc]
    scales: torch.Tensor,  # bf16/f32 [L, P, 2, 2H, ps]
    rows: torch.Tensor,  # int8 [L, T, 2, HDc]
    sc: torch.Tensor,  # scales.dtype [L, T, 2, 2H]
    page_ids: torch.Tensor,  # int32 [T], -1 = drop
    slots: torch.Tensor,  # int32 [T]
) -> None:
    L, P, _, ps, hdc = data.shape
    H2 = scales.shape[3]
    T = rows.shape[1]
    _build.check_operands((
        (data, torch.int8, (L, P, 2, ps, hdc), "data"),
        (scales, scales.dtype, (L, P, 2, H2, ps), "scales"),
        (rows, torch.int8, (L, T, 2, hdc), "rows"),
        (sc, scales.dtype, (L, T, 2, H2), "sc"),
        (page_ids, torch.int32, (T,), "page_ids"),
        (slots, torch.int32, (T,), "slots"),
    ))
    if scales.element_size() not in (2, 4):
        raise ValueError(f"scales must be 2- or 4-byte floats, got {scales.dtype}")
    if T == 0:
        return
    fn = _build.function("kv_append", "qs_kv_append", _ARGS)
    rc = fn(
        rows.data_ptr(), sc.data_ptr(), data.data_ptr(), scales.data_ptr(),
        page_ids.data_ptr(), slots.data_ptr(),
        L, T, P, ps, hdc, H2, scales.element_size(), _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
