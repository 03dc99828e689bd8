"""K3: wrapper of the causal varlen prefill attention kernel
(csrc/flash_attention.cu).

Replaces qserve_tpu/kernels/pallas_flash_attention.py
flash_prefill_attention_pallas. Unlike that kernel's dispatch, which
declined T % 128 != 0, this one takes any T: the port has no fallback.

Each sequence of `segment_ids` must be one contiguous run of the stream, as
the engine packs it (the TPU kernel's window assumes the same): the kernel
starts a query tile's key loop at the start of its first sequence's run.
"""

from __future__ import annotations

import torch

from qserve_tpu_torch.kernels import _build

HEAD_DIMS = (64, 96, 128, 256)
NAME = "flash_prefill_attention"
_ARGS = [_build.P] * 5 + [_build.I] * 4 + [_build.F, _build.I, _build.P]


def flash_prefill_attention(
    q: torch.Tensor,  # bf16 [T, Hq, D]
    k: torch.Tensor,  # bf16 [T, Hkv, D]
    v: torch.Tensor,  # bf16 [T, Hkv, D]
    segment_ids: torch.Tensor,  # int32 [T], 0 = padding
    sm_scale: float,
    window: int = 0,
) -> torch.Tensor:
    T, Hq, D = q.shape
    Hkv = k.shape[1]
    _build.check_operands((
        (q, torch.bfloat16, (T, Hq, D), "q"),
        (k, torch.bfloat16, (T, Hkv, D), "k"),
        (v, torch.bfloat16, (T, Hkv, D), "v"),
        (segment_ids, torch.int32, (T,), "segment_ids"),
    ))
    if D not in HEAD_DIMS or Hq % Hkv or Hq // Hkv > 8:
        raise ValueError(f"flash prefill needs D in {HEAD_DIMS}, Hq/Hkv <= 8 "
                         f"(D={D}, Hq={Hq}, Hkv={Hkv})")
    out = torch.empty_like(q)
    if T == 0:
        return out
    fn = _build.function("flash_attention", "qs_flash_prefill_attention", _ARGS)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(),
        out.data_ptr(), T, Hq, Hkv, D, float(sm_scale), int(window),
        _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
