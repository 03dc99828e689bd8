"""K4: wrapper of the paged quantized (KV4 or KV8) decode attention kernel
(csrc/paged_attention.cu).

Replaces qserve_tpu/kernels/pallas_paged_attention.py
paged_decode_attention_pallas together with its dispatch's exact
current-token merge. Takes one layer of the stacked cache (`data[li]`,
`scales[li]`: views, no copy) and scales in bf16 or f32. The cache mode is
read off the width of a data row: H*D/2 bytes is KV4, H*D bytes is KV8.

The history is cut into `num_splits` ranges (flash-decoding): with more
than one, the kernel writes each range's softmax state to f32 scratch from
`torch.empty` and a second kernel of the same library merges them with the
current token (one launch of the wrapper, counted once).
"""

from __future__ import annotations

import torch

from qserve_tpu_torch.kernels import _build

HEAD_DIMS = (64, 96, 128, 256)
NAME = "paged_decode_attention"
_ARGS = (
    [_build.P] * 3 + [_build.I] + [_build.P] * 8 + [_build.I] * 8
    + [_build.F, _build.I, _build.P]
)
CHUNK = 64  # keys a chunk of the kernel
# blocks to aim for: ~4 waves of the card's resident blocks (132 SMs, 3-5
# blocks each); at B = 64 this split count measured 10% faster than one
# wave (scripts/ab_decode_gemm.py)
TARGET_BLOCKS = 2048
MIN_CHUNKS = 4  # chunks a split at the longest history the table can hold


def num_splits(B: int, H: int, max_keys: int) -> int:
    """Ranges each (sequence, kv head)'s history is cut into: enough blocks
    to fill the card, each split at least MIN_CHUNKS chunks of the longest
    history the block table admits (a host bound: the kernel cuts each
    sequence's actual history evenly). The model runner passes a table as
    wide as the batch's longest history, so this reads the histories, not
    max_model_len."""
    chunks = -(-max_keys // CHUNK)
    want = -(-TARGET_BLOCKS // max(B * H, 1))
    return max(1, min(want, -(-chunks // MIN_CHUNKS)))


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
    if kv_bits is None or D not in HEAD_DIMS or Hq % H or Hq // H > 8:
        raise ValueError(f"paged decode needs KV4 or KV8 rows, D in {HEAD_DIMS}, "
                         f"Hq/H <= 8 (D={D}, Hq={Hq}, H={H}, row bytes={hdc})")
    out = torch.empty_like(q)
    if B == 0:
        return out
    ns = num_splits(B, H, maxP * ps)
    scratch = (None, None, None)
    if ns > 1:  # (m, l, o) of every split: one f32 buffer, three regions
        n = B * Hq * ns
        buf = torch.empty(n * (D + 2), dtype=torch.float32, device=q.device)
        p = buf.data_ptr()
        scratch = (p, p + 4 * n, p + 8 * n)
    fn = _build.function("paged_attention", "qs_paged_decode_attention", _ARGS)
    rc = fn(
        q.data_ptr(), data.data_ptr(), scales.data_ptr(),
        int(scales.dtype == torch.bfloat16),
        block_tables.data_ptr(), context_lens.data_ptr(),
        k_cur.data_ptr(), v_cur.data_ptr(), out.data_ptr(), *scratch,
        B, Hq, H, D, kv_bits, ps, maxP, ns, float(sm_scale), int(window),
        _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
