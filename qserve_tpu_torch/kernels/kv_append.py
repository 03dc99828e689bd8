"""K5: wrapper of the fused KV quantize-and-append kernel (csrc/kv_append.cu).

Replaces qserve_tpu/kernels/pallas_kv_append.py kv_append_inplace (decode)
and kv_write_pages_inplace (prefill), and the quantization the JAX package
ran before them in XLA (qserve_tpu/kernels/kv_cache.py _quantize_rows): one
launch reads every layer's new bf16 K/V, quantizes each (layer, token, kv,
head) vector and writes its packed row and its scale and zero into their
(page, slot). Updates the cache IN PLACE (the JAX package aliased its
buffers; here the tensors are simply written). Its plain version is
kernels/kv_cache.py `append_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qserve_tpu_torch.kernels import _build

NAME = "kv_append"
THREADS = 256  # csrc/kv_append.cu's block
MAX_D = 256  # head dims the kernel takes (even, at most this)
SMEM_LIMIT = 48 * 1024  # dynamic shared memory without an opt-in
FULL_GRID = 8 * 132  # blocks of 256 threads that fill the H100's 132 SMs
SMALL_BLOCK = 64  # vectors a block of a grid that does not fill the card
_ARGS = [_build.P] * 2 + [_build.L] * 4 + [_build.P] * 4 + [_build.I] * 11 + [_build.P]


class LaunchShape(NamedTuple):
    lanes: int  # lanes a vector with 16-byte loads (8, 16, 32), 0: scalar path
    tb: int  # consecutive tokens a block


def smem_bytes(H: int, tb: int) -> int:
    """Shared memory a block takes (csrc/kv_append.cu smem_bytes): tb pages
    and slots, the staged [2, 2H, tb] scale bits, the scalar path's codes."""
    return tb * 2 * 4 + 2 * 2 * H * tb * 4 + THREADS // 32 * MAX_D


def launch_shape(L: int, T: int, H: int, D: int, kv_bits: int, aligned: bool) -> LaunchShape:
    """The vector path takes D % 8 == 0 (D % 16 for KV4, whose partner
    nibble sits D/16 lanes on) on 16-byte aligned operands; G = the power of
    two at or above D / 8, at least 8. tb: 16 tokens a block where that
    still gives FULL_GRID blocks (a prefill: 16-slot scale runs), else (a
    decode batch) the most of 16, 8, 4, 2, 1 whose 2H * tb vectors stay
    within SMALL_BLOCK (H100 700 W, scripts/ab_kv_append.py)."""
    if D % 2 or not 0 < D <= MAX_D:
        raise ValueError(f"head dim {D}: the kernel takes even dims up to {MAX_D}")
    lanes = 0
    if aligned and D % (16 if kv_bits == 4 else 8) == 0:
        lanes = max(8, 1 << (D // 8 - 1).bit_length())
    tb = 16
    if L * -(-T // tb) < FULL_GRID:
        tb = next((n for n in (16, 8, 4, 2) if 2 * H * n <= SMALL_BLOCK), 1)
    while tb > 1 and smem_bytes(H, tb) > SMEM_LIMIT:
        tb //= 2
    if smem_bytes(H, tb) > SMEM_LIMIT:
        raise ValueError(f"{H} kv heads: the staged scales exceed shared memory")
    return LaunchShape(lanes, tb)


def _check_kv(x: torch.Tensor, shape, what: str) -> None:
    """bf16 [L, T, H, D] on the card, heads and dims dense, any layer and
    token strides (the mixed step's k_all[:, :T] and k_all[:, T:])."""
    if not x.is_cuda or x.dtype != torch.bfloat16 or tuple(x.shape) != shape:
        raise ValueError(f"{what}: want CUDA {torch.bfloat16} {shape}, got {x.device} "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.stride(3) != 1 or x.stride(2) != shape[3]:
        raise ValueError(f"{what}: heads and dims must be dense, strides {x.stride()}")


def kv_append(
    data: torch.Tensor,  # int8 [L, P, 2, ps, H*Dc]
    scales: torch.Tensor,  # bf16/f32 [L, P, 2, 2H, ps]
    k: torch.Tensor,  # bf16 [L, T, H, D]
    v: torch.Tensor,  # bf16 [L, T, H, D]
    page_ids: torch.Tensor,  # int32 [T], -1 = drop
    slots: torch.Tensor,  # int32 [T]
    kv_bits: int,
    zero_point: bool,
) -> None:
    L, P, _, ps, hdc = data.shape
    H2 = scales.shape[3]
    T, H, D = k.shape[1], H2 // 2, k.shape[3]
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    _build.check_operands((
        (data, torch.int8, (L, P, 2, ps, hdc), "data"),
        (scales, scales.dtype, (L, P, 2, H2, ps), "scales"),
        (page_ids, torch.int32, (T,), "page_ids"),
        (slots, torch.int32, (T,), "slots"),
    ))
    _check_kv(k, (L, T, H, D), "k")
    _check_kv(v, (L, T, H, D), "v")
    if scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scales must be bf16 or f32, got {scales.dtype}")
    if hdc != H * (D // 2 if kv_bits == 4 else D):
        raise ValueError(f"data rows of {hdc} bytes do not hold {H} heads of "
                         f"{D} dims at KV{kv_bits}")
    if T == 0:
        return
    aligned = all(x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0
                  for x in (k, v))
    shape = launch_shape(L, T, H, D, kv_bits, aligned)
    fn = _build.function("kv_append", "qs_kv_quant_append", _ARGS)
    rc = fn(
        k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        data.data_ptr(), scales.data_ptr(), page_ids.data_ptr(), slots.data_ptr(),
        L, T, P, ps, H, D, kv_bits, int(zero_point), scales.element_size(),
        shape.lanes, shape.tb, _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
