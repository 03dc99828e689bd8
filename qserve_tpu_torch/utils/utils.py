"""Small shared utilities (reference: qserve/utils/utils.py)."""

from __future__ import annotations

import enum


class Counter:
    def __init__(self, start: int = 0) -> None:
        self.counter = start

    def __next__(self) -> int:
        i = self.counter
        self.counter += 1
        return i

    def reset(self) -> None:
        self.counter = 0


class Device(enum.Enum):
    DEVICE = enum.auto()  # the accelerator (CUDA)
    CPU = enum.auto()


def next_power_of_2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def bucket(x: int, floor: int, cap: int) -> int:
    """Round x up to a power of two within [floor, cap]."""
    return min(max(next_power_of_2(x), floor), cap)


def resolve_device(device) -> "torch.device":
    """The port's entry points run on the card unless the caller asks for
    the CPU; asking for CUDA where there is none raises."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return dev
