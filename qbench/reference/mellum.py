"""Plain f32 reference of Mellum: the Mixtral reference
(qbench/reference/mixtral.py) with a window and a RoPE per layer.

A "sliding_attention" layer attends over the last `sliding_window` keys, a
"full_attention" one over all; each rotates q and k by its layer type's
`rope_parameters`: the plain RoPE at its rope_theta, or YaRN (Hugging Face's
`_compute_yarn_parameters`, truncate on), written out below: the correction
dimensions of beta_fast and beta_slow turns over the original context, a
linear ramp between them from the plain frequencies to the plain ones over
`factor`, and cos and sin both times `attention_factor`. A window layer's
attention runs over the keys its window can reach, block by block of query
rows (the same scores: the keys left out are the masked ones).

Departures from the published model, as the program's: no MTP head, no
QK-norm (config.json declares neither).
"""

from __future__ import annotations

import math

import torch

from qbench.reference import mistral, mixtral


def yarn_inv_freq(dim: int, theta: float, p: dict) -> torch.Tensor:
    factor = float(p["factor"])
    orig = float(p["original_max_position_embeddings"])

    def correction_dim(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(float(p.get("beta_fast") or 32))), 0)
    high = min(math.ceil(correction_dim(float(p.get("beta_slow") or 1))), dim - 1)
    if low == high:
        high += 0.001
    half = dim // 2
    plain = theta ** (-torch.arange(0, half, dtype=torch.float32) / half)
    ramp = ((torch.arange(half, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return plain * (1 - ramp) + plain / factor * ramp


def rope(x, pos, p: dict):
    """x [S, H, D] rotated at positions pos [S] by one rope_parameters entry."""
    theta = float(p["rope_theta"])
    kind = p.get("rope_type", "default")
    if kind == "default":
        return mistral.rope(x, pos, theta)
    if kind != "yarn":
        raise NotImplementedError(f"rope_type {kind!r}")
    att = p.get("attention_factor")
    att = 0.1 * math.log(float(p["factor"])) + 1.0 if att is None else float(att)
    half = x.shape[-1] // 2
    freqs = yarn_inv_freq(x.shape[-1], theta, p).to(x.device)
    ang = pos.to(torch.float32)[:, None] * freqs[None, :]
    c, s = (torch.cos(ang) * att)[:, None, :], (torch.sin(ang) * att)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Reference(mixtral.Reference):
    def window(self, li: int):
        return self.sz.windows[li]

    def rope(self, x, pos, li: int):
        return rope(x, pos, self.sz.ropes[li])

    def _attend(self, q, k, v, seg, pos, window):
        if window is None:
            return super()._attend(q, k, v, seg, pos, window)
        out = torch.empty_like(q)
        block = max(self.q_block, window)
        for b0 in range(0, q.shape[0], block):
            b1, a = min(q.shape[0], b0 + block), max(0, b0 - window + 1)
            out[b0:b1] = super()._attend(q[a:b1], k[a:b1], v[a:b1], seg[a:b1], pos[a:b1],
                                         window)[b0 - a:]
        return out
