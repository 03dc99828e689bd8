"""Attention ops: packed-varlen prefill, chunked prefill over a cached
prefix, and paged quantized decode (qserve_tpu/kernels/attention.py).

A CUDA tensor launches the op's kernel (kernels/flash_attention.py,
kernels/prefix_attention.py, kernels/paged_attention.py); a CPU tensor
takes the plain version beside it, a transcription of the JAX package's XLA
fallback. The plain versions are what the kernels are held against on the
card. The kernels serve both cache modes, KV4 and KV8.
"""

from __future__ import annotations

from typing import Optional

import torch

from qserve_tpu_torch.kernels import kv_cache as kvc

NEG_INF = -1e30


def prefill_attention_plain(
    q: torch.Tensor,  # [T, Hq, D]
    k: torch.Tensor,  # [T, Hkv, D]
    v: torch.Tensor,  # [T, Hkv, D]
    segment_ids: torch.Tensor,  # [T] int32, 0 = padding
    sm_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    T, Hq, D = q.shape
    rep = Hq // k.shape[1]
    sm = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    kq = k.repeat_interleave(rep, dim=1).float()  # [T, Hq, D]
    vq = v.repeat_interleave(rep, dim=1).float()
    scores = torch.einsum("thd,shd->hts", q.float(), kq) * sm
    same = segment_ids[:, None] == segment_ids[None, :]
    valid = (segment_ids > 0)[:, None] & (segment_ids > 0)[None, :]
    ti = torch.arange(T, device=q.device)[:, None]
    si = torch.arange(T, device=q.device)[None, :]
    mask = same & valid & (si <= ti)
    if sliding_window is not None:
        mask = mask & (si > ti - sliding_window)
    scores = torch.where(mask[None], scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("hts,shd->thd", p, vq)
    return out.to(q.dtype)


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    sm_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal self-attention over a packed batch of variable-length prompts:
    query t attends key s iff seg[s] == seg[t] > 0 and s <= t (and within
    the window). Rows of padding (seg 0) attend nothing; their values are
    never read (the plain version averages V there, the kernel writes 0)."""
    if q.is_cuda:
        from qserve_tpu_torch.kernels.flash_attention import (
            flash_prefill_attention,
        )

        D = q.shape[-1]
        return flash_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            sm_scale if sm_scale is not None else 1.0 / (D**0.5),
            sliding_window or 0,
        )
    return prefill_attention_plain(q, k, v, segment_ids, sm_scale, sliding_window)


def prefix_prefill_attention_plain(
    q: torch.Tensor,  # [T, Hq, D] chunk queries (RoPE'd, positions >= start)
    k: torch.Tensor,  # [T, Hkv, D] chunk keys
    v: torch.Tensor,  # [T, Hkv, D]
    segment_ids: torch.Tensor,  # [T] int32, 0 = padding (one live segment)
    positions: torch.Tensor,  # [T] int32 absolute positions in the sequence
    cache: kvc.KVCache,
    block_tables: torch.Tensor,  # [1, maxP] int32, the sequence's pages
    prefix_len: int,  # cached positions [0, prefix_len)
    layer_idx: int,
    kv_bits: int,
    sm_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Online softmax over ~1K-key chunks of the cached prefix, then the
    chunk's own keys: transient memory is O(Hq * T * 1K) whatever
    max_model_len is. Pages past prefix_len are not visited (their keys are
    all masked, which leaves the running softmax as it was)."""
    T, Hq, D = q.shape
    rep = Hq // k.shape[1]
    sm = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    layer = cache.layer(layer_idx)
    ps = layer.page_size
    prefix_len = int(prefix_len)
    ppc = max(1, 1024 // ps)  # pages per chunk
    used = min(-(-prefix_len // ps), block_tables.shape[1])

    qf = q.float()
    qv = segment_ids > 0
    pos = positions.long()
    m = torch.full((Hq, T, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((Hq, T, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((Hq, T, D), dtype=torch.float32, device=q.device)

    def merge(m, l, acc, kf, vf, mask):
        """One block of keys kf/vf [S, Hq, D] under mask [T, S]."""
        scores = torch.einsum("thd,shd->hts", qf, kf) * sm
        scores = torch.where(mask[None], scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("hts,shd->htd", p, vf)
        return m_new, l, acc

    def window_mask(mask, key_pos):
        if sliding_window is None:
            return mask
        return mask & (key_pos[None, :] > pos[:, None] - sliding_window)

    for p0 in range(0, used, ppc):
        pages = block_tables[:1, p0 : p0 + ppc]
        kc, vc = kvc.gather_dequant_layer(layer, pages, kv_bits)
        kc = kc[0].repeat_interleave(rep, dim=1)  # [cS, Hq, D]
        vc = vc[0].repeat_interleave(rep, dim=1)
        key_pos = p0 * ps + torch.arange(kc.shape[0], device=q.device)
        mask = (
            (key_pos < prefix_len)[None, :] & qv[:, None]
            & (key_pos[None, :] <= pos[:, None])
        )
        m, l, acc = merge(m, l, acc, kc, vc, window_mask(mask, key_pos))

    # the chunk's own T keys, merged into the running softmax
    ks = k.float().repeat_interleave(rep, dim=1)
    vs = v.float().repeat_interleave(rep, dim=1)
    mask = qv[None, :] & qv[:, None] & (pos[None, :] <= pos[:, None])
    m, l, acc = merge(m, l, acc, ks, vs, window_mask(mask, pos))

    out = acc / l.clamp(min=1e-30)
    return out.transpose(0, 1).to(q.dtype)


def prefix_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    positions: torch.Tensor,
    cache: kvc.KVCache,
    block_tables: torch.Tensor,
    prefix_len: int,
    layer_idx: int,
    kv_bits: int,
    sm_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Chunked-prefill attention (chunked prefill and prefix compute-skip):
    one sequence's chunk attends its cached prefix pages (keys below the
    host integer prefix_len) plus its own tokens causally, by absolute
    position. Rows of padding attend nothing; their values are never read
    (the plain version averages V there, the kernel writes 0)."""
    if q.is_cuda:
        from qserve_tpu_torch.kernels.prefix_attention import (
            prefix_prefill_attention as kernel,
        )

        D = q.shape[-1]
        # a mixed step hands in row slices of the packed stream
        return kernel(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            positions, cache.data[layer_idx], cache.scales[layer_idx],
            block_tables[0].contiguous(), prefix_len,
            sm_scale if sm_scale is not None else 1.0 / (D**0.5),
            sliding_window or 0,
        )
    return prefix_prefill_attention_plain(
        q, k, v, segment_ids, positions, cache, block_tables, prefix_len,
        layer_idx, kv_bits, sm_scale, sliding_window,
    )


def paged_decode_attention_plain(
    q: torch.Tensor,  # [B, Hq, D]
    cache: kvc.KVCache,
    block_tables: torch.Tensor,  # [B, maxP]
    context_lens: torch.Tensor,  # [B] incl. the current token
    layer_idx: int,
    k_cur: torch.Tensor,  # [B, Hkv, D]
    v_cur: torch.Tensor,
    kv_bits: int,
    sm_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    B, Hq, D = q.shape
    layer = cache.layer(layer_idx)
    S = block_tables.shape[1] * layer.page_size
    sm = sm_scale if sm_scale is not None else 1.0 / (D**0.5)
    k, v = kvc.gather_dequant_layer(layer, block_tables, kv_bits)  # [B,S,H,D]
    Hkv = k.shape[2]
    rep = Hq // Hkv
    # the current token is one extra, exact history column
    k = torch.cat([k, k_cur.float()[:, None]], dim=1)
    v = torch.cat([v, v_cur.float()[:, None]], dim=1)
    qf = q.float().reshape(B, Hkv, rep, D)
    scores = torch.einsum("bhrd,bshd->bhrs", qf, k) * sm
    pos = torch.arange(S + 1, device=q.device)[None, :]
    hist = torch.clamp(context_lens.long() - 1, min=0)[:, None]
    in_hist = pos < hist
    if sliding_window is not None:
        in_hist = in_hist & (pos > hist - sliding_window)
    mask = in_hist | (pos == S)
    scores = torch.where(
        mask[:, None, None, :], scores, torch.full_like(scores, NEG_INF)
    )
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrs,bshd->bhrd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    cache: kvc.KVCache,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    layer_idx: int,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    kv_bits: int,
    sm_scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """One query token per sequence over its quantized paged history
    (positions < ctx-1) plus the current token's exact K/V. Rows with
    ctx == 0 are padding and attend only their own k_cur/v_cur."""
    if q.is_cuda:
        from qserve_tpu_torch.kernels.paged_attention import (
            paged_decode_attention as kernel,
        )

        D = q.shape[-1]
        return kernel(
            q.contiguous(), cache.data[layer_idx], cache.scales[layer_idx],
            block_tables, context_lens, k_cur.contiguous(), v_cur.contiguous(),
            sm_scale if sm_scale is not None else 1.0 / (D**0.5),
            sliding_window or 0,
        )
    return paged_decode_attention_plain(
        q, cache, block_tables, context_lens, layer_idx, k_cur, v_cur, kv_bits,
        sm_scale, sliding_window,
    )
