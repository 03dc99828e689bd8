"""K7: wrapper of the filtered (top-k / top-p) sampling kernel
(csrc/sampler.cu).

Replaces qserve_tpu/kernels/pallas_sampler.py _sample_call. The TPU
kernel's shape limits (B % 8, V % 128) do not apply. Randomness is
explicit: the kernel draws its Gumbel noise from Philox keyed by the
(seed, offset) it is given, or takes the noise as a [B, V] operand, which
makes a draw checkable bit for bit against the plain version.

Each row runs on a thread-block cluster whose CTAs hold the row in their
shared memory, slice by slice: `cluster_split` picks the cluster on the
host from V.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from qserve_tpu_torch.kernels import _build

NAME = "sample_filtered"
_U64 = ctypes.c_uint64
_ARGS = [_build.P] * 4 + [_U64, _U64, _build.P] + [_build.I] * 7 + [_build.P]

COLUMNS_PER_CTA = 4096
MAX_CLUSTER = 8  # the portable cluster size
# f32 columns a CTA may hold: the H100's 227 KB of shared memory a block,
# less 1 KB for the kernel's own arrays, in 16-byte vectors
MAX_SLICE = (232448 - 1024) // 16 * 4


class ClusterSplit(NamedTuple):
    cluster: int  # CTAs a row
    slice: int  # columns a CTA: CTA r holds [r * slice, (r + 1) * slice) ∩ [0, V)
    threads: int = 256  # a CTA's


def cluster_split(V: int) -> ClusterSplit:
    """One CTA for every 4096 columns, up to 8, so a row spreads over up to
    8 SMs; slices are whole 16-byte vectors. A CTA holding more than 8192
    columns runs 512 threads (V = 128256 at 1-16 rows: 0.080 against 0.101
    ms with 256, H100 700 W, scripts/ab_elementwise_sampler.py), else 256
    (V = 32000 at 64 rows: 0.069 against 0.110)."""
    cluster = max(1, min(MAX_CLUSTER, -(-V // COLUMNS_PER_CTA)))
    sl = 4 * -(-V // (4 * cluster))
    if sl > MAX_SLICE:
        raise ValueError(
            f"vocabulary {V} exceeds {MAX_CLUSTER} x {MAX_SLICE} columns of "
            "shared memory")
    return ClusterSplit(cluster, sl, 512 if sl > 2 * COLUMNS_PER_CTA else 256)


def sample_filtered(
    scaled: torch.Tensor,  # f32 [B, V], logits / temperature
    k_eff: torch.Tensor,  # int32 [B] in [1, V]; V = top-k off
    top_p: torch.Tensor,  # f32 [B], floored at 1e-9; >= 1 = top-p off
    do_topk: bool,  # some row has k_eff < V (decided on the host)
    do_topp: bool,  # some row has top_p < 1
    seed: int = 0,
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,  # f32 [B, V] Gumbel noise
) -> torch.Tensor:
    """Token ids int32 [B]: argmax(scaled + g) over each row's exact
    top-k / top-p kept set."""
    B, V = scaled.shape
    checks = [
        (scaled, torch.float32, (B, V), "scaled"),
        (k_eff, torch.int32, (B,), "k_eff"),
        (top_p, torch.float32, (B,), "top_p"),
    ]
    if noise is not None:
        checks.append((noise, torch.float32, (B, V), "noise"))
    _build.check_operands(checks)
    out = torch.empty((B,), dtype=torch.int32, device=scaled.device)
    if B == 0:
        return out
    split = cluster_split(V)
    fn = _build.function("sampler", "qs_sample_filtered", _ARGS)
    mask64 = (1 << 64) - 1
    rc = fn(
        scaled.data_ptr(), k_eff.data_ptr(), top_p.data_ptr(),
        noise.data_ptr() if noise is not None else None,
        int(seed) & mask64, int(offset) & mask64, out.data_ptr(), B, V,
        split.cluster, split.slice, split.threads, int(do_topk), int(do_topp),
        _build.stream(),
    )
    _build.check(NAME, rc)
    _build.count_launch(NAME)
    return out
