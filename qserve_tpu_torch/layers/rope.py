"""Rotary position embeddings, GPT-NeoX style (qserve_tpu/layers/rope.py).
Plain PyTorch on every device: the JAX package left RoPE to XLA."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """positions [T] int -> (cos, sin) each f32 [T, head_dim//2]."""
    half = head_dim // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, D]; cos/sin [T, D//2]. Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, None, :], sin[:, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
