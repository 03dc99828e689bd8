"""Batched token sampling (qserve_tpu/layers/sampler.py).

Per-request temperature / top-k / top-p arrive as host tensors [B], so the
branch between greedy, raw-temperature and filtered sampling is decided on
the host without reading the device; they reach the device through pinned
staging copies (utils.to_device), which do not wait for the card.

  all greedy                    -> argmax
  raw temperature (no filters)  -> Gumbel-argmax over the scaled row
  top-k / top-p                 -> the exact kept sets, then a Gumbel-argmax
                                   over them: on CUDA the filtered-sampler
                                   kernel (kernels/sampler.py), on the CPU
                                   its plain version, the JAX package's
                                   sort-free threshold bisection
                                   (threshold_mask).

The random draws are explicit: a torch.Generator for the plain draws, a
(seed, offset) pair drawn on the host from `seed_generator` for the
kernel's counter-based generator, or a caller's [B, V] Gumbel noise in
place of either. They differ from jax.random's, so only greedy streams and
draws under injected noise are comparable across the packages.
"""

from __future__ import annotations

from typing import Optional

import torch

from qserve_tpu_torch.utils.utils import to_device

NEG_INF = -1e30

_BISECT_PASSES = 14  # 9^14 ~ 2^44 interval shrink: past f32 resolution
_BISECT_SUB = 8  # 8 thresholds evaluated per pass

def _bisect_threshold(values, weights, target, lo0, hi0):
    """Per-row threshold lo of the decreasing step function
    f(t) = sum_j weights[:, j] * (values[:, j] > t) with f(lo) >= target, so
    the kept set {values > lo} is exactly {x : f(values[x]) < target}.
    weights=None counts."""
    frac = (
        torch.arange(1, _BISECT_SUB + 1, dtype=torch.float32, device=values.device)
        / (_BISECT_SUB + 1)
    )
    lo, hi = lo0, hi0
    for _ in range(_BISECT_PASSES):
        ts = lo[:, None] + (hi - lo)[:, None] * frac[None, :]  # [B, S]
        gt = values[:, :, None] > ts[:, None, :]  # [B, V, S]
        if weights is None:
            f = gt.to(torch.float32).sum(dim=1)
        else:
            f = torch.where(gt, weights[:, :, None], 0.0).sum(dim=1)
        ge = f >= target[:, None]
        lo = torch.where(ge, ts, lo[:, None]).amax(dim=1)
        hi = torch.where(ge, hi[:, None], ts).amin(dim=1)
    return lo


def threshold_mask(scaled, top_p, top_k):
    """Masked logits keeping exactly the reference top-k/top-p sets (the
    plain transcription of the JAX package's threshold_mask)."""
    B, V = scaled.shape
    rowmax = scaled.amax(dim=-1)
    rowmin = scaled.amin(dim=-1)
    k_eff = torch.where(top_k <= 0, V, top_k.clamp(1, V))
    if bool((k_eff < V).any()):
        lo = _bisect_threshold(
            scaled, None, k_eff.to(torch.float32), rowmin - 1.0, rowmax
        )
        mask1 = scaled > lo[:, None]
    else:
        mask1 = torch.ones_like(scaled, dtype=torch.bool)
    masked = torch.where(mask1, scaled, NEG_INF)
    if not bool((top_p < 1.0).any()):
        return masked
    lse = torch.logsumexp(masked, dim=-1, keepdim=True)
    probs = torch.exp(masked - lse)
    target = top_p.clamp(min=1e-9)
    m_min = torch.where(mask1, scaled, torch.inf).amin(dim=-1)
    lo_p = _bisect_threshold(masked, probs, target, m_min - 1.0, rowmax)
    return torch.where(masked > lo_p[:, None], masked, NEG_INF)


def sample_filtered_plain(scaled, top_p, top_k, noise):
    """Plain version of the filtered-sampler kernel: the Gumbel-argmax of
    `noise` over threshold_mask's kept sets. Token ids int64 [B]."""
    return (threshold_mask(scaled, top_p, top_k) + noise).argmax(dim=-1)


def _sample_filtered_cuda(scaled, top_p, top_k, noise, seed_generator):
    """The filtered-sampler kernel on host filter vectors [B]; which
    bisections the batch needs is decided here, on the host."""
    from qserve_tpu_torch.kernels.sampler import sample_filtered

    V = scaled.shape[1]
    k_eff = torch.where(top_k <= 0, V, top_k.clamp(1, V)).to(torch.int32)
    p_target = top_p.clamp(min=1e-9).to(torch.float32)
    seed = offset = 0
    if noise is None:
        if seed_generator is None:
            raise ValueError(
                "filtered sampling on CUDA needs a host seed_generator or noise"
            )
        seed, offset = torch.randint(
            0, 2**62, (2,), generator=seed_generator, dtype=torch.int64
        ).tolist()
    dev = scaled.device
    return sample_filtered(
        scaled.contiguous(), to_device(k_eff, dev), to_device(p_target, dev),
        bool((k_eff < V).any()), bool((top_p < 1.0).any()),
        seed, offset, noise,
    )


def sample(
    logits: torch.Tensor,  # [B, V] f32/bf16 on the compute device
    temperature: torch.Tensor,  # host f32 [B]; 0 => greedy
    top_p: torch.Tensor,  # host f32 [B] in (0, 1]
    top_k: torch.Tensor,  # host int32 [B]; 0 or >= V => off
    generator: torch.Generator,  # on logits.device
    seed_generator: Optional[torch.Generator] = None,  # on the host
    noise: Optional[torch.Tensor] = None,  # f32 [B, V] Gumbel noise
) -> torch.Tensor:
    """Returns sampled token ids [B] int32 on logits.device."""
    logits = logits.to(torch.float32)
    B, V = logits.shape
    greedy_ids = logits.argmax(dim=-1).to(torch.int32)
    sampling = temperature > 0.0
    if V <= 1 or not bool(sampling.any()):
        return greedy_ids
    dev = logits.device
    k_eff = torch.where(top_k <= 0, V, top_k.clamp(1, V))
    filtered = sampling & ((k_eff < V) | (top_p < 1.0))
    scaled = logits / to_device(temperature.clamp(min=1e-6), dev)[:, None]
    sampling_dev = to_device(sampling, dev)
    if bool(filtered.any()):
        # rows without a filter of their own get top_p = 1, top_k = 0, so
        # the bisections see exactly the rows that need them
        p_eff = torch.where(filtered, top_p, 1.0)
        k_in = torch.where(filtered, top_k, 0)
        if logits.is_cuda:
            sampled = _sample_filtered_cuda(scaled, p_eff, k_in, noise, seed_generator)
            return torch.where(sampling_dev, sampled, greedy_ids)
        scaled = threshold_mask(scaled, p_eff, k_in)
    if noise is None:
        u = torch.rand(scaled.shape, generator=generator, device=dev)
        noise = -torch.log(-torch.log(u))
    sampled = (scaled + noise).argmax(dim=-1).to(torch.int32)
    return torch.where(sampling_dev, sampled, greedy_ids)
