"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): HBM bytes/s and tensor-core ops/s."""

HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_OPS = 989e12
F32_OPS = 67e12  # outside the tensor cores


def bound_s(nbytes: float, ops: float, peak: float = INT8_OPS) -> float:
    """The least time the work can take: its bytes at the HBM rate or its
    operations at the peak, whichever is longer."""
    return max(nbytes / HBM_BPS, ops / peak)
