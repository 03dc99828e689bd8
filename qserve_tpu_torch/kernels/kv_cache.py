"""Paged, quantized KV cache as plain tensors (qserve_tpu/kernels/kv_cache.py).

Layout (stacked on a leading layer axis, the JAX package's own):
  data   : int8 [L, P, 2, ps, H*Dc]   axis 2: 0=K 1=V
           KV4: Dc = D//2, two UINT4 values per byte along head_dim,
           half-split per head (dims < D/2 low nibble, >= D/2 high nibble).
           KV8: Dc = D, one byte per value, stored as u-128.
  scales : bf16/f32 [L, P, 2, 2*H, ps]  row h = per-slot scale of head h,
           row H+h = per-slot zero of head h.

The cache is updated IN PLACE (the JAX package returned new arrays and
aliased the buffers); `append_all_layers` returns the same KVCache.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from qserve_tpu_torch.quant import packing, qoq
from qserve_tpu_torch.utils.utils import resolve_device


class KVCache(NamedTuple):
    data: torch.Tensor  # int8 [L, P, 2, ps, H*Dc]
    scales: torch.Tensor  # bf16/f32 [L, P, 2, 2H, ps]

    @property
    def num_layers(self) -> int:
        return self.data.shape[0]

    @property
    def num_pages(self) -> int:
        return self.data.shape[-4]

    @property
    def page_size(self) -> int:
        return self.data.shape[-2]

    @property
    def num_kv_heads(self) -> int:
        return self.scales.shape[-2] // 2

    def head_dim(self, kv_bits: int) -> int:
        dc = self.data.shape[-1] // self.num_kv_heads
        return dc * 2 if kv_bits == 4 else dc

    def layer(self, i: int) -> "KVCache":
        return KVCache(self.data[i], self.scales[i])


def scale_dtype_for(num_kv_heads: int) -> torch.dtype:
    """bf16 scales when 2 * num_kv_heads % 16 == 0, else f32 (the JAX
    package's rule, kv_cache.py:89-91; a TP shard keeps its global cache's)."""
    return torch.bfloat16 if (2 * num_kv_heads) % 16 == 0 else torch.float32


def create_kv_cache(
    num_layers: int,
    num_pages: int,
    num_kv_heads: int,
    page_size: int,
    head_dim: int,
    kv_bits: int = 4,
    scale_dtype=None,
    device="cuda",
) -> KVCache:
    """Zeroed cache. Scales are bf16 when 2*num_kv_heads % 16 == 0, else
    f32 (the JAX package's rule, kv_cache.py:89-91)."""
    device = resolve_device(device)
    assert head_dim % 2 == 0
    dc = head_dim // 2 if kv_bits == 4 else head_dim
    if scale_dtype is None:
        scale_dtype = scale_dtype_for(num_kv_heads)
    return KVCache(
        data=torch.zeros(
            (num_layers, num_pages, 2, page_size, num_kv_heads * dc),
            dtype=torch.int8, device=device,
        ),
        scales=torch.zeros(
            (num_layers, num_pages, 2, 2 * num_kv_heads, page_size),
            dtype=scale_dtype, device=device,
        ),
    )


def quantize_kv_unpacked(
    x: torch.Tensor, kv_bits: int, zero_point: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., D] fp -> (q int32 in [0, 2^bits-1], scale, zero [...]).

    Symmetric quant (zero_point=False) is stored in the same unsigned affine
    form with zero = -2^(bits-1) * scale, so dequant is uniform."""
    q, scale, zero = qoq.quantize_kv(x, bits=kv_bits, asymmetric=zero_point)
    q = q.to(torch.int32) & 0xFF
    if not zero_point:
        half = 1 << (kv_bits - 1)
        q = (q + half) & ((1 << kv_bits) - 1)
        zero = -half * scale
    return q, scale[..., 0], zero[..., 0]


def _quantize_rows(k_all, v_all, kv_bits, zero_point):
    """[L, T, H, D] k/v -> packed data rows int8 [L, T, 2, H*Dc] and
    scale rows f32 [L, T, 2, 2H]: the quantizing half of `append_plain`
    (the JAX package ran it in XLA, outside its append kernels)."""
    L, T = k_all.shape[:2]
    kq, ks, kz = quantize_kv_unpacked(k_all, kv_bits, zero_point)
    vq, vs, vz = quantize_kv_unpacked(v_all, kv_bits, zero_point)
    q = torch.stack([kq, vq], dim=2)  # [L, T, 2, H, D] int32
    if kv_bits == 4:
        rows = packing.pack_kv4(q).reshape(L, T, 2, -1)
    else:
        rows = (q - 128).to(torch.int8).reshape(L, T, 2, -1)
    sc = torch.stack(
        [torch.cat([ks, kz], -1), torch.cat([vs, vz], -1)], dim=2
    )  # [L, T, 2, 2H]
    return rows.contiguous(), sc


def append_rows_plain(
    cache: KVCache,
    rows: torch.Tensor,  # int8 [L, T, 2, H*Dc]
    sc: torch.Tensor,  # cache.scales.dtype [L, T, 2, 2H]
    page_ids: torch.Tensor,  # int32 [T], -1 = drop
    slots: torch.Tensor,  # int32 [T]
) -> None:
    """The scattering half of `append_plain`:
    data[l, page, kv, slot, :] = rows[l, t, kv, :] and
    scales[l, page, kv, :, slot] = sc[l, t, kv, :] for every valid token."""
    valid = page_ids >= 0
    pages = page_ids[valid].long()
    sl = slots[valid].long()
    # non-adjacent advanced indices put the token dim first: [T', L, 2, ...]
    cache.data[:, pages, :, sl, :] = rows[:, valid].transpose(0, 1)
    cache.scales[:, pages, :, :, sl] = sc[:, valid].transpose(0, 1)


def append_plain(
    cache: KVCache,
    k_all: torch.Tensor,  # [L, T, H, D] fp (already RoPE'd)
    v_all: torch.Tensor,  # [L, T, H, D]
    page_ids: torch.Tensor,  # [T] int32 (-1 = drop)
    slots: torch.Tensor,  # [T] int32
    kv_bits: int,
    zero_point: bool,
) -> None:
    """Plain version of the fused K5 kernel (kernels/kv_append.py): the
    JAX package's quantize (_quantize_rows), then the row scatter."""
    rows, sc = _quantize_rows(k_all, v_all, kv_bits, zero_point)
    append_rows_plain(cache, rows, sc.to(cache.scales.dtype), page_ids, slots)


def append_all_layers(
    cache: KVCache,
    k_all: torch.Tensor,  # [L, T, H, D] fp (already RoPE'd)
    v_all: torch.Tensor,  # [L, T, H, D]
    page_ids: torch.Tensor,  # [T] int32 (-1 = drop)
    slots: torch.Tensor,  # [T] int32
    kv_bits: int,
    zero_point: bool,
) -> KVCache:
    """Quantize every layer's new tokens and write them into their
    (page, slot), in place. On CUDA that is one launch of the fused K5
    kernel for the decode append and the prefill page write alike (the TPU
    quantized in XLA and needed staged whole-page DMAs for the latter)."""
    if cache.data.is_cuda:
        from qserve_tpu_torch.kernels.kv_append import kv_append

        kv_append(cache.data, cache.scales, k_all, v_all, page_ids, slots,
                  kv_bits, zero_point)
    else:
        append_plain(cache, k_all, v_all, page_ids, slots, kv_bits, zero_point)
    return cache


def gather_dequant_layer(
    layer: KVCache,
    block_tables: torch.Tensor,  # [B, maxP] int (pad with 0)
    kv_bits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + dequantize one layer's pages (the plain attention path).
    Returns (k, v) as f32 [B, maxP*ps, H, D]."""
    B, maxP = block_tables.shape
    ps = layer.page_size
    H = layer.num_kv_heads
    D = layer.head_dim(kv_bits)
    dc = layer.data.shape[-1] // H
    bt = block_tables.long()

    d = layer.data[bt].to(torch.int32)  # [B, maxP, 2, ps, H*Dc]
    d = d.reshape(B, maxP, 2, ps, H, dc)
    if kv_bits == 4:
        d = d & 0xFF
        d = torch.cat([d & 0xF, (d >> 4) & 0xF], dim=-1)  # [B,maxP,2,ps,H,D]
    else:
        d = d + 128  # stored as u-128
    x = d.to(torch.float32)

    s = layer.scales[bt].to(torch.float32)  # [B, maxP, 2, 2H, ps]
    sc = s[..., :H, :].transpose(-1, -2)[..., None]  # [B, maxP, 2, ps, H, 1]
    zp = s[..., H:, :].transpose(-1, -2)[..., None]
    out = x * sc + zp
    k = out[:, :, 0].reshape(B, maxP * ps, H, D)
    v = out[:, :, 1].reshape(B, maxP * ps, H, D)
    return k, v
