"""Rotary position embeddings, GPT-NeoX style (qserve_tpu/layers/rope.py).
Plain PyTorch on every device: the JAX package left RoPE to XLA.

Besides the plain RoPE of one base (`theta`), YaRN (`Yarn`, Hugging Face's
rope_type "yarn", `_compute_yarn_parameters` with `truncate` on): the
frequencies that turn fewer than `beta_slow` times over the original context
are divided by `factor`, those that turn more than `beta_fast` times are
kept, a linear ramp over the dimensions joins the two, and cos and sin are
both multiplied by `attention_factor`, so q.k scales by its square."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Yarn:
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: Optional[float] = None  # None: 0.1 ln(factor) + 1

    @property
    def scale(self) -> float:
        """What cos and sin are multiplied by."""
        if self.attention_factor is not None:
            return float(self.attention_factor)
        return 0.1 * math.log(self.factor) + 1.0 if self.factor > 1 else 1.0


@dataclasses.dataclass(frozen=True)
class RopeSpec:
    """One RoPE a layer rotates q and k with: plain at `theta`, or YaRN."""

    theta: float = 10000.0
    yarn: Optional[Yarn] = None


_YARN_KEYS = {"rope_type", "type", "rope_theta", "factor", "original_max_position_embeddings",
              "beta_fast", "beta_slow", "attention_factor", "truncate"}


def spec_from_config(params: Optional[dict], theta: float) -> RopeSpec:
    """The RoPE of a Hugging Face `rope_scaling` or `rope_parameters` dict
    (None: plain at `theta`; the dict's own `rope_theta` wins). A type the
    port does not compute is refused by name, never served unscaled."""
    if not params:
        return RopeSpec(float(theta))
    kind = params.get("rope_type", params.get("type", "default"))
    theta = float(params.get("rope_theta", theta))
    if kind == "default":
        return RopeSpec(theta)
    if kind != "yarn":
        raise NotImplementedError(f"rope_type {kind!r} is not implemented by the port")
    extra = set(params) - _YARN_KEYS
    if extra or params.get("truncate", True) is not True:
        raise NotImplementedError(
            f"YaRN with {sorted(extra) or ['truncate false']} is not implemented by the port")
    return RopeSpec(theta, Yarn(
        factor=float(params["factor"]),
        original_max_position_embeddings=int(params["original_max_position_embeddings"]),
        beta_fast=float(params.get("beta_fast") or 32.0),
        beta_slow=float(params.get("beta_slow") or 1.0),
        attention_factor=params.get("attention_factor")))


def yarn_range(yarn: Yarn, head_dim: int, theta: float) -> Tuple[int, int]:
    """(low, high): the dimensions the ramp runs between, from the number of
    turns beta_fast and beta_slow over the original context."""
    def dim_of(turns):
        return (head_dim * math.log(yarn.original_max_position_embeddings
                                    / (turns * 2 * math.pi))) / (2 * math.log(theta))
    low = math.floor(dim_of(yarn.beta_fast))
    high = math.ceil(dim_of(yarn.beta_slow))
    return max(low, 0), min(high, head_dim - 1)


def inv_freq(head_dim: int, theta: float = 10000.0, yarn: Optional[Yarn] = None,
             device=None) -> torch.Tensor:
    """f32 [head_dim // 2]: theta^(-2i / head_dim), YaRN's where given."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    if yarn is None:
        return freqs
    low, high = yarn_range(yarn, head_dim, theta)
    if low == high:
        high += 0.001  # as Hugging Face: no division by zero
    i = torch.arange(half, dtype=torch.float32, device=device)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    return freqs * (1.0 - ramp) + (freqs / yarn.factor) * ramp


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 yarn: Optional[Yarn] = None):
    """positions [T] int -> (cos, sin) each f32 [T, head_dim//2]."""
    freqs = inv_freq(head_dim, theta, yarn, positions.device)
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if yarn is not None:
        cos, sin = cos * yarn.scale, sin * yarn.scale
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, D]; cos/sin [T, D//2]. Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[:, None, :], sin[:, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
