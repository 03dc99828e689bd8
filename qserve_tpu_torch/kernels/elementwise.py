"""K1: wrapper of the fused elementwise/quant kernel (csrc/elementwise.cu).

Replaces: qserve_tpu/kernels/pallas_elementwise.py _add_rmsnorm_quant_jit,
_quant_jit, _silu_mul_quant_jit and _rmsnorm_quant_jit.

Each op is one pass over a token row: read it, reduce (mean square, amax),
scale, round, write int8 codes, the per-token scale and the act-sum. What
bounds it on an H100 is the bytes of that pass (3.35 TB/s). One block owns
one row, held in registers as 16-byte vectors of 8 bf16; `launch_shape`
picks the block's threads and the vectors each holds so the row fills them
without a power-of-two pad. The wrapper goes through the port's one ctypes
C entry, as every kernel does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from qserve_tpu_torch.kernels import _build

NAME = "elementwise"

MODE_QUANT = 0
MODE_RMSNORM = 1
MODE_ADD_RMSNORM = 2
MODE_SILU_MUL = 3

VEC = 8  # columns a vector: 16 bytes of bf16
MAX_THREADS = 1024  # csrc/elementwise.cu's __launch_bounds__: 64 registers a thread
MAX_VPT = 8  # vectors a thread holds as bf16: 32 registers
MAX_VPT_F32 = 4  # as f32 (mode 3's silu(g) * u): 32 registers
FEW_ROWS = 264  # fewer rows than 2 an SM of the H100's 132
_ARGS = [_build.I] + [_build.P] * 7 + [_build.I] * 2 + [_build.F] + [_build.I] * 3 + [_build.P]


class LaunchShape(NamedTuple):
    threads: int  # a row's block: a multiple of 32, at most MAX_THREADS
    vpt: int  # vectors a thread holds, 1..MAX_VPT
    chunks: int  # passes of threads * vpt vectors over the row (1 up to 65536 columns)
    tail: int  # columns of the last vector (VEC unless W % VEC)


@functools.lru_cache(maxsize=64)  # a model has a few widths: a dict lookup a call
def launch_shape(W: int, f32: bool = False, few_rows: bool = False) -> LaunchShape:
    """The block for a row of W columns, held as f32 (mode 3) or as bf16,
    in a launch of fewer than FEW_ROWS rows or not. Vector j = (c * vpt +
    v) * threads + t of chunk c, slot v, thread t covers columns [8j, 8j +
    8) ∩ [0, W). Picks the fewest idle vector slots; then, over many rows,
    4 vectors a thread (they beat 1, 2, 7 and 8 at T = 2048, W = 4096 and
    14336, in every mode the engine runs there) and, over few rows, the
    fewest (the most threads a row: best at T = 64); then the block nearest
    256 threads (H100 700 W, scripts/ab_elementwise_sampler.py;
    PERF.md)."""
    if W <= 0:
        raise ValueError(f"row width {W} must be positive")
    top = MAX_VPT_F32 if f32 else MAX_VPT
    nv = -(-W // VEC)
    chunks = -(-nv // (MAX_THREADS * top))
    per_chunk = -(-nv // chunks)
    best = None
    for vpt in range(1, top + 1):
        threads = 32 * -(-per_chunk // (32 * vpt))
        if threads > MAX_THREADS:
            continue
        key = (threads * vpt - per_chunk, vpt if few_rows else abs(vpt - 4),
               abs(threads - 256))
        if best is None or key < best[0]:
            best = (key, threads, vpt)
    _, threads, vpt = best
    return LaunchShape(threads, vpt, chunks, W - VEC * (nv - 1))


def _check(t: torch.Tensor, dtype, what: str, ndim: int = 2) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-d tensor, got {tuple(t.shape)}")


def launch(
    mode: int,
    x: torch.Tensor,
    delta: Optional[torch.Tensor] = None,
    weight: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (h_new | None, q int8 [T, W], scale f32 [T, 1], asum f32 [T, 1])."""
    _check(x, torch.bfloat16, "x")
    T = x.shape[0]
    W = x.shape[1] // 2 if mode == MODE_SILU_MUL else x.shape[1]
    if mode == MODE_SILU_MUL and x.shape[1] != 2 * W:
        raise ValueError("silu_mul_quant needs an even width [g | u]")
    h_new = None
    if mode == MODE_ADD_RMSNORM:
        _check(delta, torch.bfloat16, "delta")
        if delta.shape != x.shape:
            raise ValueError("h and delta shapes differ")
        h_new = torch.empty_like(x)
    if mode in (MODE_RMSNORM, MODE_ADD_RMSNORM):
        _check(weight, torch.float32, "weight", ndim=1)
        if weight.shape[0] != W:
            raise ValueError("norm weight width differs from x")
    q = torch.empty((T, W), dtype=torch.int8, device=x.device)
    scale, asum = torch.empty((2, T, 1), dtype=torch.float32, device=x.device).unbind(0)
    if T == 0:
        return h_new, q, scale, asum
    shape = launch_shape(W, mode == MODE_SILU_MUL, T < FEW_ROWS)
    fn = _build.function("elementwise", "qs_fused_quant", _ARGS)
    rc = fn(
        mode, x.data_ptr(), delta.data_ptr() if delta is not None else None,
        weight.data_ptr() if weight is not None else None,
        h_new.data_ptr() if h_new is not None else None,
        q.data_ptr(), scale.data_ptr(), asum.data_ptr(), T, W, float(eps),
        shape.threads, shape.vpt, shape.chunks, _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return h_new, q, scale, asum
